"""CUDA runtime launch calls (kernel and graph launches) the profiler
records inside the program's decode step functions, over the decode steps
of the traced rounds."""


def read(ctx):
    tr = ctx["trace"]
    launches = tr.get("launches", {}).get("decode")
    if not launches or not tr.get("decode_steps"):
        return None
    return launches / tr["decode_steps"]
