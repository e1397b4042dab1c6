"""Share of the traced rounds' decode steps that replayed a CUDA graph, %:
the program's counter ``graph.replays`` inside its ``serve.decode_step``
spans, over those spans.  A program that steps eagerly counts 0; nothing
to read where the program records no spans, decodes nothing, or counts no
``graph.replays`` at all (a program without the graph)."""
from cardbench.spans import program


def read(ctx):
    rec = program(ctx)
    if not rec or not rec["decode_step"]["n"]:
        return None
    replays = rec["counts"].get("serve.decode_step", {}).get("graph.replays")
    if replays is None:
        return None
    return 100.0 * replays / rec["decode_step"]["n"]
