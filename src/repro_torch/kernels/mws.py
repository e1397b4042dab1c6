"""Flash-Cosmos multi-wordline-sensing bulk bitwise ops on Hopper (IFP).

Flash-Cosmos activates up to 48 wordlines at once: the series cells of a
NAND string give the wired-AND of the stacked pages (the OR across blocks),
in one array sense, with an inverted read for NAND/NOR.  The reduce is
``stack[n_ops, rows, cols] -> [rows, cols]`` over the operand axis.

Replaces the Pallas kernel ``repro/kernels/mws.py`` ``_mws_kernel`` with
the CUDA kernel ``mws_kernel`` of ``csrc/ndp.cu``.  The TPU kernel holds
all n_ops pages of an (8, 128)-aligned tile in VMEM and reduces them in
registers; here one flat grid-stride pass over the ``rows * cols``
elements keeps each element's accumulator in a register while it reads
element i of every operand page once, neighbouring threads on neighbouring
addresses of one page.  There is no tile, so no row or column count needs
padding.  Bound on an H100: bytes, (n_ops + 1) * itemsize per element
against n_ops one-cycle logic ops (PERF.md).  int8 and int32 run on the
unsigned view.

``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

DTYPES = (torch.int8, torch.int32)
# in the order of MwsOp in csrc/ndp.cu
OPS = ("and", "or", "xor", "nand", "nor")
_SUFFIX = {torch.int8: "i8", torch.int32: "i32"}

LAUNCHES = 0


def mws_bitwise(stack: torch.Tensor, op: str = "and") -> torch.Tensor:
    """Bulk bitwise reduce of ``stack[n_ops, rows, cols]`` over axis 0."""
    global LAUNCHES
    _build.check_operands("mws_bitwise", DTYPES, stack)
    if stack.ndim != 3:
        raise ValueError(f"mws_bitwise: expected [n_ops, rows, cols], got "
                         f"{tuple(stack.shape)}")
    if op not in OPS:
        raise ValueError(f"mws_bitwise: op {op!r} not one of {OPS}")
    n_ops, rows, cols = stack.shape
    out = torch.empty((rows, cols), dtype=stack.dtype, device=stack.device)
    _build.call(f"ndp_mws_{_SUFFIX[stack.dtype]}", stack.data_ptr(),
                out.data_ptr(), n_ops, rows * cols, OPS.index(op),
                torch.cuda.current_stream(stack.device).cuda_stream)
    LAUNCHES += 1
    return out
