"""Plain PyTorch versions and oracles of the NDP-resource kernels.

For each kernel two functions, mirroring ``repro.kernels.ref``:

* ``*_plain`` — the kernel's gate-level loop written in torch ops (the same
  rounds of XOR / AND / shift / predicated add the CUDA kernel runs).  On a
  CPU tensor :mod:`repro_torch.kernels.ops` computes with it; on the card
  it is what each kernel is held against.
* ``ref_*`` — the mathematical specification (the correctness ground
  truth): integer add, multiply, multiply by the masked multiplier, a
  bitwise reduce, word equality.

Integer tensors wrap on overflow, as the JAX package's int8/int32 arrays
do, so all of these are exact.
"""
from __future__ import annotations

import functools

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


# accumulator of the multi-wordline sense before the first page
_MWS_INIT = {"and": -1, "nand": -1, "or": 0, "nor": 0, "xor": 0}


def mws_plain(stack: torch.Tensor, op: str) -> torch.Tensor:
    """Flash-Cosmos sense: each operand page of ``stack[n_ops, rows,
    cols]`` read once and folded into the accumulator (AND for and/nand,
    OR for or/nor, XOR for xor); nand/nor invert the result."""
    acc = torch.full(stack.shape[1:], _MWS_INIT[op], dtype=stack.dtype,
                     device=stack.device)
    for page in stack:
        if op in ("and", "nand"):
            acc = acc & page
        elif op in ("or", "nor"):
            acc = acc | page
        else:
            acc = acc ^ page
    return ~acc if op in ("nand", "nor") else acc


def search_plain(stack: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Match line: the XNOR of each record word with its query word ANDed
    onto an all-ones line; a record matches iff the line stays all ones."""
    rows, words = stack.shape
    wpr = query.shape[0]
    recv = stack.reshape(rows, words // wpr, wpr)
    line = torch.full(recv.shape[:2], -1, dtype=stack.dtype,
                      device=stack.device)
    for k in range(wpr):
        line = line & ~(recv[..., k] ^ query[k])
    return line == -1


def ref_mws(stack: torch.Tensor, op: str) -> torch.Tensor:
    """Multi-wordline-sensing bulk bitwise reduce over operand axis 0."""
    base = {"nand": "and", "nor": "or"}.get(op, op)
    fn = {"and": torch.bitwise_and, "or": torch.bitwise_or,
          "xor": torch.bitwise_xor}[base]
    out = functools.reduce(fn, stack.unbind(0))
    return ~out if base != op else out


def ref_search(stack: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Exact-match search oracle: record r of page p matches iff all its
    words equal the query words."""
    rows, words = stack.shape
    recv = stack.reshape(rows, words // query.shape[0], query.shape[0])
    return (recv == query).all(dim=-1)
