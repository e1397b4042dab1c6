"""Megabytes of fp32 copies of the KV caches a decode step makes: the
program's counter ``attn.cast_bytes`` inside its ``serve.decode_step``
spans, over the traced rounds' decode steps, / 1e6.  Nothing to read where
the program records no spans or decodes nothing."""
from cardbench.spans import program


def read(ctx):
    rec = program(ctx)
    if not rec or not rec["decode_step"]["n"]:
        return None
    cast = rec["counts"].get("serve.decode_step", {}).get("attn.cast_bytes")
    if cast is None:
        return None
    return cast / rec["decode_step"]["n"] / 1e6
