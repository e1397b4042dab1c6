"""Host time of a prefill less its read-back: the program's
``serve.prefill`` spans (from ``t_start`` to ``t_first``) less their
``serve.sync`` children, over the traced rounds' prefills; what of
``prefill_ms`` the host spends issuing work and not waiting for the
device.  Nothing to read where the program records no spans."""
from cardbench.spans import program


def read(ctx):
    rec = program(ctx)
    if not rec or not rec["prefill"]["n"]:
        return None
    return rec["prefill"]["host_ms"] / rec["prefill"]["n"]
