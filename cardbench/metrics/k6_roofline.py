"""K6's share of its roofline, in percent: the least time the H100 could
take for the causal attention of the traced prefills (the larger of
bytes over 3.35 TB/s and flops over the working type's peak, counted from
the shapes alone by ``counts.k6_call``) over the device time of the
kernels named ``flash_attn_mma_kernel``.  Nothing to read where that
kernel did not run."""


def read(ctx):
    counts, tr = ctx["counts"], ctx["trace"]
    from cardbench.trace import kernel_seconds
    seconds = kernel_seconds(tr, counts.K6_KERNEL)
    if not seconds or not tr.get("k6_bound_s"):
        return None
    return tr["k6_bound_s"] / seconds * 100.0
