"""Mean host time of a round's prefill: from the start of its batch in
the program's serving loop to its first tokens on the host (the program's
``Request.t_start`` and ``t_first``), over the window's rounds."""


def read(ctx):
    rounds = ctx["window"].get("rounds") or []
    if not rounds:
        return None
    return sum(r["t_first"] - r["t_start"] for r in rounds) / len(rounds) \
        * 1e3
