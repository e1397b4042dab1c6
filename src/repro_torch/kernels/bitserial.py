"""SIMDRAM/MIMDRAM bit-serial arithmetic on Hopper (PuD-SSD model).

Replaces the Pallas kernels ``repro/kernels/bitserial.py`` ``_add_kernel``
and ``_mul_kernel`` with the CUDA kernels of ``csrc/ndp.cu``.  The adder
and the multiplier use ONLY the PuD primitive set {AND, OR, XOR, NOT, MAJ,
shift} — gate-level circuits as SIMDRAM synthesizes them — so each kernel
is a functional model of the in-DRAM computation; no hardware add or
multiply touches the data.

The adder (``bitserial_add_kernel``) is a log-depth (Kogge-Stone) prefix
circuit, where the TPU kernel ripples the carry through W rounds (3W + 1
operations an element, 97 for int32, which would bind an H100 by integer
issue above the function's bytes): p = a ^ b, g = a & b, then for d = 1,
2, ..., W/2, g |= p & (g << d) and (but at the last level) p &= p << d, and
the sum is (a ^ b) ^ (g << 1) — ~22 instructions an int32 element.  int8
runs as SWAR lanes, four to a 32-bit word, each shifted term masked so no
carry crosses a byte.  A thread adds 16 bytes with one 16-byte load of
each operand and one store where a, b and out are 16-byte aligned; the
ragged end and unaligned operands (the jacobi1d sweep's ``a[1:-1]`` and
``a[2:]``) go an element at a time, 16 bytes' worth a thread, each load
still coalesced, through the same circuit.  Its function moves 3 *
itemsize bytes an element for one op, so HBM bounds it, and the circuit
issues under that bound (PERF.md).  ``ref.bitserial_add_prefix_plain``
rehearses the circuit on the CPU; the card holds the kernel against
``ref.bitserial_add_plain``, the ripple.

The multiplier (``bitserial_mul_planes_kernel``) lays the operands out as
SIMDRAM does, vertically: a lane owns 32 elements and turns each operand
into W = 8 * itemsize bit-plane words (word j holds bit j of the 32
elements) with a register butterfly transpose, after coalesced 16-byte
loads staged through swizzled shared memory.  Partial product i is plane
b_i ANDed onto a's planes shifted by i, added into the accumulator planes
i..W-1 by a ripple of full adders (sum XOR, carry MAJ; one LOP3 each), the
last carry dropped — W(W+1)/2 full adders per 32 elements.  The
accumulator is transposed back and stored; the ragged end (elements past
n read as 0 and are never stored) and unaligned operands go an element at
a time.  Its function moves the same bytes as the adder's; the circuit and
transposes issue ~95 integer operations an element, so integer issue
bounds it, at ~4x the bytes bound where the element-serial form ran at 33x
(PERF.md).

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
    """Elementwise a*b via the bit-plane shift-add circuit (CUDA)."""
    global MUL_LAUNCHES
    out = _launch("mul", a, b)
    MUL_LAUNCHES += 1
    return out
