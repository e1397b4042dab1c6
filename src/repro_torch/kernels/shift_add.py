"""Ares-Flash latch-based shift-and-add multiply on Hopper (IFP model).

Ares-Flash extends the flash plane's page-buffer latches (S/A/B/C) with
transmission gates so a page can be ANDed with a broadcast bit, shifted,
and accumulated — integer multiply as ``bits`` latch-level shift-add
rounds.  Only the low ``bits`` of the multiplier take part, exactly like
the latch datapath width.

Replaces the Pallas kernel ``repro/kernels/shift_add.py``
``_shift_add_kernel`` with the CUDA kernel ``shift_add_mul_kernel`` of
``csrc/ndp.cu``: one flat grid-stride pass, the rounds in registers on the
unsigned view (bit k of b as a predicate, a << k added under it; no
multiply in the source, each round one predicated shift-add on the card).
int32 only, as the IFP path uses it.  Where a, b and the
output are 16-byte aligned, a thread reads 4 elements of each operand with
one 16-byte load and stores 16 bytes; the last n % 4 elements and
unaligned operands go one element a thread.  The 8 rounds every replay
uses are unrolled (a template instance); other widths, 0..32, loop.  At
bits = 8 the card issues ~14 instructions an element (the multiplier's
bits moved into predicates, one predicated shift-add a round) against 12
bytes moved, under the H100's ~5 int32 ops per byte of HBM bandwidth, so
memory bounds it (PERF.md).

``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

LAUNCHES = 0


def shift_add_mul(a: torch.Tensor, b: torch.Tensor,
                  bits: int = 8) -> torch.Tensor:
    """a * (b & ((1<<bits)-1)) via the Ares-Flash shift-and-add datapath."""
    global LAUNCHES
    _build.check_pair(a, b, (torch.int32,), "shift_add_mul")
    if not 0 <= bits <= 32:
        raise ValueError(f"shift_add_mul: bits={bits} outside 0..32")
    out = torch.empty_like(a)
    _build.call("ndp_shift_add_mul_i32", a.data_ptr(), b.data_ptr(),
                out.data_ptr(), a.numel(), bits,
                torch.cuda.current_stream(a.device).cuda_stream)
    LAUNCHES += 1
    return out
