"""Host time inside the program's ``ssm.scan`` spans within its
``serve.prefill`` spans, over the traced rounds' prefills: the time loop's
share of ``prefill_ms.serve``.  Nothing to read where the program records
no spans or runs no scan."""
from cardbench.spans import program


def read(ctx):
    rec = program(ctx)
    if not rec or not rec["prefill"]["n"] or "ssm.scan" not in rec["spans"]:
        return None
    return rec["prefill"]["scan_ms"] / rec["prefill"]["n"]
