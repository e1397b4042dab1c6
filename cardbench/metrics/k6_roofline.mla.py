"""K6's share of its roofline at MLA's widths, in percent: the least time
the H100 could take for the causal attention of the traced prefills (one
K6 call a layer, q and k at depth dh + rd and v at width dh; the larger
of bytes over 3.35 TB/s and flops over the working type's peak, counted
from the shapes alone by the configuration's layout module, ``k6_call``)
over the device time of the kernels named ``flash_attn_mma_kernel``.
Nothing to read where that kernel did not run."""
from cardbench import spec
from cardbench.trace import kernel_seconds


def read(ctx):
    tr = ctx["trace"]
    seconds = kernel_seconds(tr, ctx["counts"].K6_KERNEL)
    if not seconds or not tr.get("rounds"):
        return None
    family = spec.layout(ctx["config"])
    t = ctx["traffic"]
    call = family.k6_call(ctx["arch"], t["clients"], t["prompt_len"])
    bound = tr["rounds"] * family.k6_calls_per_prefill(ctx["arch"]) \
        * call["bound_s"]
    return bound / seconds * 100.0
