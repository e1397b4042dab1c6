"""SIMDRAM/MIMDRAM bit-serial arithmetic on Hopper (PuD-SSD model).

Replaces the Pallas kernels ``repro/kernels/bitserial.py`` ``_add_kernel``
and ``_mul_kernel`` with the CUDA kernels of ``csrc/ndp.cu``.  The
ripple-carry adder and shift-add multiplier use ONLY the PuD primitive set
{AND, OR, XOR, NOT, shift} — the gate-level circuits SIMDRAM synthesizes —
so each kernel is a functional model of the in-DRAM computation.

Design: one flat grid-stride pass over the ``n`` contiguous elements, one
element per thread per step, neighbouring threads on neighbouring
addresses; every round runs in registers on the unsigned view of the
element.  Bounds on an H100: the adder's function (a + b) moves
3 * itemsize bytes per element and does one op, so HBM bounds it; its 32
rounds compile to ~100 SASS instructions per element, which fit under
that bound, and it runs within about 2x of it.  The multiplier is bound
by instruction issue instead: the compiler drops the carry rounds it
knows are zero and fuses pairs of rounds into LOP3s, leaving ~2.7k SASS
instructions per int32 element, far above the memory pass (PERF.md).  A
layout closer to SIMDRAM's vertical bit-planes (32 elements per logic op)
is the way to a faster multiplier.

``ADD_LAUNCHES`` / ``MUL_LAUNCHES`` count kernel launches, so a run can
show that it went through the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

DTYPES = (torch.int8, torch.int32)
_SUFFIX = {torch.int8: "i8", torch.int32: "i32"}

ADD_LAUNCHES = 0
MUL_LAUNCHES = 0


def _launch(kind: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _build.check_pair(a, b, DTYPES, f"bitserial_{kind}")
    out = torch.empty_like(a)
    _build.call(f"ndp_bitserial_{kind}_{_SUFFIX[a.dtype]}",
                a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(),
                torch.cuda.current_stream(a.device).cuda_stream)
    return out


def bitserial_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise a+b via the bit-serial MAJ/XOR adder (CUDA, int8/int32)."""
    global ADD_LAUNCHES
    out = _launch("add", a, b)
    ADD_LAUNCHES += 1
    return out


def bitserial_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise a*b via bit-serial shift-add partial products (CUDA)."""
    global MUL_LAUNCHES
    out = _launch("mul", a, b)
    MUL_LAUNCHES += 1
    return out
