"""Host time of the MLA attentions in a decode step: the program's
``mla`` spans inside its ``serve.decode_step`` spans, over the traced
rounds' decode steps, in ms.  Nothing to read where the program records
no spans, decodes nothing or has no such span."""
from cardbench import spec


def read(ctx):
    return spec.reader("moe_host_ms.decode").host_ms_in_decode(ctx, "mla")
