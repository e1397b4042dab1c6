"""Plain PyTorch versions and oracles of the NDP-resource kernels.

For each kernel two functions, mirroring ``repro.kernels.ref``:

* ``*_plain`` — the kernel's gate-level loop written in torch ops (the same
  rounds of XOR / AND / shift / predicated add the CUDA kernel runs; for
  the GEMM, an exact product in torch ops).  On a CPU tensor
  :mod:`repro_torch.kernels.ops` computes with it; on the card it is what
  each kernel is held against.
* ``ref_*`` — the mathematical specification (the correctness ground
  truth): integer add, multiply, multiply by the masked multiplier, a
  bitwise reduce, word equality, an int32 matrix product.

Integer tensors wrap on overflow, as the JAX package's int8/int32 arrays
do, so all of these are exact.

Attention has only its plain version, :func:`flash_attention_plain`, which
is also its specification: the JAX package's oracle ``ref_attention``
aligns the causal mask bottom-right where its kernel aligns it top-left
(ROADMAP R1), and the port follows the kernel.  The fp32 kernel is held to
it at 3e-5 (``tests/test_kernels.py``'s tolerance).  The bf16 kernel is held
at 1e-2 (atol = rtol): it rounds the softmax weights to bf16 for the
product with v (2**-9 relative a weight) and sums the normaliser from the
same rounded weights, so its output is a mean of v under weights within
2**-9 of the plain version's fp32 ones, and both round the result to bf16
once (one bf16 ulp, 2**-8 relative, apart at most from that rounding).
The largest |kernel - plain| measured on the card is in PERF.md.

Five more functions rehearse the redesigned kernels' algorithms on the
CPU (no dispatch path uses them): :func:`bitserial_add_prefix_plain`, the
PuD adder as a log-depth prefix circuit; :func:`bitserial_mul_planes_plain`,
the PuD multiplier on bit-planes; :func:`search_chunked_plain`, the match
line on 16-byte records; :func:`int8_matmul_splitk_plain`, the INT8 GEMM's
split-K sum; and :func:`flash_attention_tiled_plain`, the bf16 attention
kernel's tiled numerics.
"""
from __future__ import annotations

import functools
import math

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


def _lane_mask(width: int, d: int) -> int:
    """What a word shifted left by ``d`` keeps so that no bit crosses into
    the next ``width``-bit lane (``lane_mask`` of ``csrc/ndp.cu``), as an
    int32 value: every bit for int32, bits d..7 of each byte for int8."""
    if width == 32:
        return -1
    mask = ((0xFF << d) & 0xFF) * 0x01010101
    return mask - (1 << 32) if mask >= 1 << 31 else mask


def bitserial_add_prefix_plain(a: torch.Tensor,
                               b: torch.Tensor) -> torch.Tensor:
    """The Kogge-Stone prefix adder of ``csrc/ndp.cu`` in torch integer ops,
    gate for gate, on int32 words: int32 elements are words; int8 elements
    are packed four to a word (zero-padded at the end) and run as SWAR
    lanes, every shifted term masked so that no carry crosses a byte.
    p = a ^ b and g = a & b; for d = 1, 2, ..., W/2, g |= p & (g << d) and
    (but at the last level) p &= p << d; the sum is (a ^ b) ^ (g << 1)."""
    n, width = a.numel(), a.element_size() * 8

    def words(x):
        if width == 32:
            return x.reshape(-1)
        buf = torch.zeros(n + -n % 4, dtype=x.dtype, device=x.device)
        buf[:n] = x.reshape(-1)
        return buf.view(torch.int32)

    x, y = words(a), words(b)
    p, g = x ^ y, x & y
    d = 1
    while d < width:
        g = g | (p & ((g << d) & _lane_mask(width, d)))
        if 2 * d < width:
            p = p & ((p << d) & _lane_mask(width, d))
        d *= 2
    s = (x ^ y) ^ ((g << 1) & _lane_mask(width, 1))
    return s.view(a.dtype)[:n].reshape(a.shape)


def bitserial_mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Shift-add multiply: W predicated partial products, each folded in by
    a 2W-round ripple adder."""
    bits = a.element_size() * 8
    acc = torch.zeros_like(a)
    for i in range(bits):
        pp = torch.where(((b >> i) & 1) == 1, a << i, 0)
        acc = _ripple_add(acc, pp, 2 * bits)
    return acc


# (shift, mask) of each butterfly stage: the mask keeps the low half of
# every 2 * shift-bit group
_BUTTERFLY = {16: 0x0000FFFF, 8: 0x00FF00FF, 4: 0x0F0F0F0F, 2: 0x33333333,
              1: 0x55555555}


def _transpose_bits(words: list) -> list:
    """The CUDA kernel's ``transpose_bits`` over N int32 word tensors: swap
    bit k of the word index with bit k of the bit position for every
    k < log2 N (for N = 32 the bit-matrix transpose).  Its own inverse.
    Arithmetic shifts are exact here: the mask drops the sign bits."""
    x = list(words)
    s = len(x) // 2
    while s:
        for k in range(len(x)):
            if k & s:
                continue
            t = ((x[k] >> s) ^ x[k + s]) & _BUTTERFLY[s]
            x[k], x[k + s] = x[k] ^ (t << s), x[k + s] ^ t
        s //= 2
    return x


def bitserial_mul_planes_plain(a: torch.Tensor,
                               b: torch.Tensor) -> torch.Tensor:
    """The bit-plane PuD multiplier of ``csrc/ndp.cu`` in torch integer ops:
    each group of 32 elements (zero-padded at the end) becomes W = 8 *
    itemsize plane words by the butterfly transpose of its 32 * itemsize /
    4 little-endian words; partial product i (a's planes shifted by i,
    ANDed with plane b_i) is added into the accumulator planes i..W-1 by a
    ripple of full adders (sum XOR, carry MAJ), the last carry dropped;
    the accumulator is transposed back."""
    n, bits = a.numel(), a.element_size() * 8
    pad = -n % 32

    def planes(x):
        x = torch.nn.functional.pad(x.reshape(-1), (0, pad))
        words = x.reshape(-1, 32).view(torch.int32)    # [groups, W]
        return _transpose_bits(list(words.unbind(1)))

    pa, pb = planes(a), planes(b)
    acc = [p & pb[0] for p in pa]
    for i in range(1, bits):
        carry = torch.zeros_like(acc[0])
        for j in range(i, bits):
            x, y = acc[j], pa[j - i] & pb[i]
            acc[j] = x ^ y ^ carry
            carry = (x & y) | (carry & (x ^ y))
    words = torch.stack(_transpose_bits(acc), dim=1)
    return words.view(a.dtype).reshape(-1)[:n].reshape(a.shape)


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


def search_chunked_plain(stack: torch.Tensor,
                         query: torch.Tensor) -> torch.Tensor:
    """The match-line kernel's 16-byte path in torch ops, for records of 4
    words (the xor_filter replay's): the flattened stack as 16-byte chunks,
    one record each, every word XNORed against the query held whole and
    ANDed onto a line that starts all ones."""
    rows, words = stack.shape
    if tuple(query.shape) != (4,):
        raise ValueError(f"the 16-byte path senses records of 4 words, not "
                         f"{tuple(query.shape)}")
    sensed = ~(stack.reshape(-1, 4) ^ query)
    line = torch.full(sensed.shape[:1], -1, dtype=stack.dtype,
                      device=stack.device)
    for k in range(4):
        line = line & sensed[:, k]
    return (line == -1).reshape(rows, words // 4)


def ref_mws(stack: torch.Tensor, op: str) -> torch.Tensor:
    """Multi-wordline-sensing bulk bitwise reduce over operand axis 0."""
    base = {"nand": "and", "nor": "or"}.get(op, op)
    fn = {"and": torch.bitwise_and, "or": torch.bitwise_or,
          "xor": torch.bitwise_xor}[base]
    out = functools.reduce(fn, stack.unbind(0))
    return ~out if base != op else out


# Each int8 x int8 product is at most 2**14 in magnitude, so a float64 sum
# of up to 2**38 of them is an integer below 2**53: exact in any order.
_EXACT_K = 1 << 38


def int8_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """INT8 GEMM with int32 accumulation, exact on the CPU and on CUDA
    (which has no integer matmul): float64 products over K-chunks whose
    sums stay exact, added in int64 and wrapped to int32."""
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.int64,
                      device=a.device)
    for k0 in range(0, a.shape[1], _EXACT_K):
        part = a[:, k0:k0 + _EXACT_K].double() @ b[k0:k0 + _EXACT_K].double()
        acc += part.to(torch.int64)
    return acc.to(torch.int32)


# bytes of K a stage of the INT8 GEMM kernel (kMmBK of csrc/ndp.cu)
INT8_MM_STAGE_K = 128


def int8_matmul_splitk_plain(a: torch.Tensor, b: torch.Tensor, splits: int,
                             seed: int = 0) -> torch.Tensor:
    """The INT8 GEMM kernel's split-K sum: K's 128-byte stages cut into
    ``splits`` ranges of ceil(stages / splits) stages as its launcher cuts
    them (the last range ragged, empty ranges dropped), each range's
    product wrapped to int32, and the partial products added in int32,
    wrapping, in an order shuffled by ``seed`` (the kernel's atomics land
    in any order)."""
    k = a.shape[1]
    stages = -(-k // INT8_MM_STAGE_K)
    per = -(-stages // max(1, min(splits, stages))) if stages else 1
    bounds = [(k0, min(k, k0 + per * INT8_MM_STAGE_K))
              for k0 in range(0, k, per * INT8_MM_STAGE_K)]
    order = torch.randperm(len(bounds),
                           generator=torch.Generator().manual_seed(seed))
    out = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.int32,
                      device=a.device)
    for i in order.tolist():
        k0, k1 = bounds[i]
        out += int8_matmul_plain(a[:, k0:k1], b[k0:k1])
    return out


def ref_int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """INT8 x INT8 -> INT32 matmul (the quantized-workload GEMM, §5.4):
    int32 operands and int32 sums, on the CPU."""
    return a.to(torch.int32) @ b.to(torch.int32)


def ref_search(stack: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Exact-match search oracle: record r of page p matches iff all its
    words equal the query words."""
    rows, words = stack.shape
    recv = stack.reshape(rows, words // query.shape[0], query.shape[0])
    return (recv == query).all(dim=-1)


# the masked logit of the JAX package's attention kernel: exp(-1e30 - m)
# is 0 in fp32 for any row maximum m
NEG_INF = -1e30


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True,
                          scale: float | None = None) -> torch.Tensor:
    """Softmax attention over ``q [H, Sq, dh]``, ``k, v [H, Sk, dh]``: the
    whole ``[H, Sq, Sk]`` logits in fp32, the causal mask ``q_pos >= k_pos``
    aligned top-left (as the kernel's), the probabilities kept in fp32 for
    the product with v, and the output cast to q's type."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("hqd,hkd->hqk", q.float(), k.float()) * scale
    if causal:
        keep = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool,
                          device=q.device).tril()
        logits = logits.masked_fill(~keep, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("hqk,hkd->hqd", probs, v.float()).to(q.dtype)


# keys a K/V tile of the bf16 attention kernel
ATTN_TILE_KEYS = 64


def flash_attention_tiled_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, causal: bool = True,
                                scale: float | None = None) -> torch.Tensor:
    """The bf16 attention kernel's numerics in torch: keys in tiles of 64,
    the logits in fp32 and scaled by ``scale * log2(e)`` after the product,
    masked keys at -inf, an online softmax in base 2, the weights rounded
    to bf16 for the product with v and the normaliser summed from the same
    rounded weights; the output cast to q's type."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    heads, sq, dh = q.shape
    sk = k.shape[1]
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((heads, sq, 1), -math.inf, device=q.device)
    l = torch.zeros((heads, sq, 1), device=q.device)
    acc = torch.zeros((heads, sq, dh), device=q.device)
    rows = torch.arange(sq, device=q.device)[:, None]
    for k0 in range(0, sk, ATTN_TILE_KEYS):
        k1 = min(sk, k0 + ATTN_TILE_KEYS)
        s = torch.einsum("hqd,hkd->hqk", qf, kf[:, k0:k1]) * (
            scale * math.log2(math.e))
        if causal:
            keys = torch.arange(k0, k1, device=q.device)[None, :]
            s = s.masked_fill(keys > rows, -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new).to(torch.bfloat16).float()
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("hqk,hkd->hqd", p, vf[:, k0:k1])
        m = m_new
    return (acc / l).to(q.dtype)
