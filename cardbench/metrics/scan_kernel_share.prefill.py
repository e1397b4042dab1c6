"""Share of a prefill's time-scan steps that the program computes through
its whole-scan path (``ops.selective_scan``: one kernel launch a scan on
the card), in %: its counter ``ssm.scan_kernel_steps`` over
``ssm.scan_steps`` (both added once a scan, by its steps) inside its
``serve.prefill`` spans, over the traced rounds' prefills.  Nothing to
read where the program records no spans, runs no scan or has no such
path."""
from cardbench.spans import program


def read(ctx):
    rec = program(ctx)
    if not rec or not rec["prefill"]["n"]:
        return None
    counts = rec["counts"].get("serve.prefill", {})
    steps = counts.get("ssm.scan_steps")
    kernel = counts.get("ssm.scan_kernel_steps")
    if not steps or kernel is None:
        return None
    return kernel / steps * 100
