"""The prefills' share of the chip's peak, in percent: the model flops of
the window's prefills (``counts.prefill_flops``) over their summed host
time (``t_first - t_start``), over the peak of the configuration's
working type."""


def read(ctx):
    rounds = ctx["window"].get("rounds") or []
    seconds = sum(r["t_first"] - r["t_start"] for r in rounds)
    if not rounds or seconds <= 0:
        return None
    flops = sum(r["prefill_flops"] for r in rounds)
    peak = ctx["counts"].PEAK_FLOPS[ctx["arch"]["dtype"]]
    return flops / seconds / peak * 100.0
