"""Megabytes of MLA cache a decode step reads and makes: the program's
counter ``mla.cache_bytes`` (the latent and rope cache a cached MLA call
reads, and any keys or values of the cache's length it makes from them)
inside its ``serve.decode_step`` spans, over the traced rounds' decode
steps, / 1e6.  Nothing to read where the program records no spans,
decodes nothing or keeps no such counter."""
from cardbench.spans import program


def read(ctx):
    rec = program(ctx)
    if not rec or not rec["decode_step"]["n"]:
        return None
    read_bytes = rec["counts"].get("serve.decode_step", {}).get(
        "mla.cache_bytes")
    if read_bytes is None:
        return None
    return read_bytes / rec["decode_step"]["n"] / 1e6
