"""Host time of the MoE layers in a decode step: the program's ``moe``
spans inside its ``serve.decode_step`` spans, over the traced rounds'
decode steps, in ms.  Nothing to read where the program records no spans,
decodes nothing or has no such span."""
import importlib

from cardbench.spans import program


def host_ms_in_decode(ctx, name):
    """Milliseconds of the spans ``name`` whose innermost ``serve.*``
    span is a decode step, over the decode steps; None where there are
    none."""
    rec = program(ctx)
    if not rec or not rec["decode_step"]["n"]:
        return None
    record = importlib.import_module("repro_torch.spans").last_profiled()
    spans = record.spans()
    serve_of = {}
    for s in spans:
        serve_of[s["id"]] = (s["name"] if s["name"].startswith("serve.")
                             else serve_of.get(s["parent"], ""))
    mine = [s for s in spans if s["name"] == name
            and serve_of[s["id"]] == "serve.decode_step"]
    if not mine:
        return None
    return sum(s["end_ns"] - s["start_ns"] for s in mine) / 1e6 \
        / rec["decode_step"]["n"]


def read(ctx):
    return host_ms_in_decode(ctx, "moe")
