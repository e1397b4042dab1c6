"""Host time of a decode step: each round's last token time less its first
token time, summed over the window's rounds, over the decode steps they
took.  Nothing to read where no round decodes."""


def read(ctx):
    rounds = ctx["window"].get("rounds") or []
    steps = sum(r["decode_steps"] for r in rounds)
    if not steps:
        return None
    return sum(r["t_done"] - r["t_first"] for r in rounds) / steps * 1e3
