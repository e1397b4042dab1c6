"""Flash-Cosmos multi-wordline-sensing bulk bitwise ops on Hopper (IFP).

Flash-Cosmos activates up to 48 wordlines at once: the series cells of a
NAND string give the wired-AND of the stacked pages (the OR across blocks),
in one array sense, with an inverted read for NAND/NOR.  The reduce is
``stack[n_ops, rows, cols] -> [rows, cols]`` over the operand axis.

Replaces the Pallas kernel ``repro/kernels/mws.py`` ``_mws_kernel`` with
the CUDA kernel ``mws_kernel`` of ``csrc/ndp.cu``.  The TPU kernel holds
all n_ops pages of an (8, 128)-aligned tile in VMEM and reduces them in
registers; here a thread senses 16 bytes of the output, with a 16-byte
load of each page at the same offset, and folds them in registers (the
fold is bitwise, so int8 and int32 are the same words).  For 1 to 4 pages
(the counts the aes and xor_filter senses use) every page's load is issued
before the first fold, so a thread has all of them in flight; other counts
go in groups of four loads, then their folds.  The grid covers the output
in one pass where it can.  Indices are 32-bit where ``n_ops * rows *
cols`` allows.  A stack or output not 16-byte aligned, or pages whose
length is not a multiple of 16 bytes, go an element at a time, as does the
ragged end.  There is no tile, so no row or column count needs padding.
Bound on an H100: the bytes, (n_ops + 1) * itemsize an element, against
n_ops - 1 one-instruction folds (PERF.md).

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
