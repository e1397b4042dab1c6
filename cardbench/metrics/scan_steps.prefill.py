"""Time-scan steps of a prefill: the program's counter ``ssm.scan_steps``
(added once a scan, by its steps) inside its ``serve.prefill`` spans, over
the traced rounds' prefills.  Nothing to read where the program records
no spans or runs no scan."""
from cardbench.spans import program


def read(ctx):
    rec = program(ctx)
    if not rec or not rec["prefill"]["n"]:
        return None
    steps = rec["counts"].get("serve.prefill", {}).get("ssm.scan_steps")
    if steps is None:
        return None
    return steps / rec["prefill"]["n"]
