"""CUDA runtime launch calls (kernel and graph launches) the profiler
records inside the program's prefill step functions, over the prompt
tokens of the traced rounds."""


def read(ctx):
    tr = ctx["trace"]
    launches = tr.get("launches", {}).get("prefill")
    if not launches or not tr.get("prompt_tokens"):
        return None
    return launches / tr["prompt_tokens"]
