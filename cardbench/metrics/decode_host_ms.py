"""Host time of a decode step less its read-back: the program's
``serve.decode_step`` spans less their ``serve.sync`` children, over the
traced rounds' decode steps; the host's part of ``decode_step_ms``.
Nothing to read where the program records no spans or decodes nothing."""
from cardbench.spans import program


def read(ctx):
    rec = program(ctx)
    if not rec or not rec["decode_step"]["n"]:
        return None
    return rec["decode_step"]["host_ms"] / rec["decode_step"]["n"]
