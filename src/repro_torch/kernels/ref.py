"""Plain PyTorch versions and oracles of the NDP-resource kernels.

For each kernel two functions, mirroring ``repro.kernels.ref``:

* ``*_plain`` — the kernel's gate-level loop written in torch ops (the same
  rounds of XOR / AND / shift / predicated add the CUDA kernel runs).  On a
  CPU tensor :mod:`repro_torch.kernels.ops` computes with it; on the card
  it is what each kernel is held against.
* ``ref_*`` — the mathematical specification (the correctness ground
  truth): integer add, multiply, multiply by the masked multiplier.

Integer tensors wrap on overflow, as the JAX package's int8/int32 arrays
do, so all of these are exact.
"""
from __future__ import annotations

import torch


def _ripple_add(x: torch.Tensor, y: torch.Tensor, rounds: int) -> torch.Tensor:
    """``rounds`` rounds of s = x ^ y (XOR row-op), c = (x & y) << 1 (MAJ
    row-op + shift); the carry has left a W-bit word after W rounds."""
    for _ in range(rounds):
        x, y = x ^ y, (x & y) << 1
    return x | y


def bitserial_add_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SIMDRAM ripple-carry add over W = 8 * itemsize rounds."""
    return _ripple_add(a, b, a.element_size() * 8)


def bitserial_mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Shift-add multiply: W predicated partial products, each folded in by
    a 2W-round ripple adder."""
    bits = a.element_size() * 8
    acc = torch.zeros_like(a)
    for i in range(bits):
        pp = torch.where(((b >> i) & 1) == 1, a << i, 0)
        acc = _ripple_add(acc, pp, 2 * bits)
    return acc


def shift_add_mul_plain(a: torch.Tensor, b: torch.Tensor,
                        bits: int = 8) -> torch.Tensor:
    """Ares-Flash latch rounds: ``bits`` rounds of acc += b_i ? a << i : 0."""
    acc = torch.zeros_like(a)
    for i in range(bits):
        acc = acc + torch.where(((b >> i) & 1) == 1, a << i, 0)
    return acc


def ref_bitserial_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Bit-serial ripple add (SIMDRAM MAJ/XOR circuit) == integer add."""
    return a + b


def ref_bitserial_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Bit-serial shift-add multiply == integer multiply (wrapping)."""
    return a * b


def ref_shift_add_mul(a: torch.Tensor, b: torch.Tensor,
                      bits: int = 8) -> torch.Tensor:
    """Ares-Flash shift-and-add over the low ``bits`` of b (unsigned)."""
    mask = (1 << bits) - 1
    return a * (b & mask)
