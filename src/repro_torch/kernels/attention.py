"""Attention with an online softmax on Hopper (the LM prefill path).

Replaces the Pallas kernel ``repro/kernels/attention.py`` ``_attn_kernel``
(grid (heads, q-blocks); one q tile in VMEM, k/v tiles streamed with a
running (max, normaliser, accumulator), no ``[Sq, Sk]`` score matrix) with
two CUDA kernels of ``csrc/attention.cu``, chosen by the element type:

* bf16: ``flash_attn_mma_kernel``, FlashAttention-2 on the tensor cores.
  A block of 4 warps owns one head and 64 q rows; q, K and V pass through
  shared memory as bf16 (``cp.async``, K/V tiles of 64 keys
  double-buffered); both products are ``mma.sync`` m16n8k16 with fp32
  accumulators, the scale applied after q·kᵀ, the online softmax on the
  accumulator fragments, and P rounded to bf16 in registers for P·v, with
  the normaliser summed from the same rounded weights.  Bound on an H100
  at the serving shape: the bytes of q, k, v and out (PERF.md).
* fp32: ``flash_attn_kernel`` on the CUDA cores, fp32 throughout (TF32
  would lose the fp32 tolerance): a block of 256 threads owns one head and
  a tile of q rows, a row split over dh / 16 lanes, K/V tiles streamed
  through shared memory, eight keys scored per rescale; held by the fp32
  rate.

The output is in q's type; the causal mask is ``q_pos >= k_pos`` aligned
top-left, as the TPU kernel's; any Sq and Sk pass unpadded.  q and k share
a depth and v's width equals it (16, 32, 64 or 128), except MLA's pair
(``HEAD_DIMS``): q·k at depth 192 (DeepSeek-V2's 128 + 64 rotary) and v
of width 128, which the bf16 kernel alone is built for.  Both kernels
read q, k and v in 16-byte chunks (``cp.async`` and ``ldmatrix`` in
bf16), so the wrapper copies an operand whose data pointer is not 16-byte
aligned (a contiguous view at an odd offset) into a fresh tensor first;
the output is a fresh tensor.  The wrapper checks the return of every
call.

``LAUNCHES`` counts launches of either kernel.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

DTYPES = (torch.float32, torch.bfloat16)
# (q·k depth, v width) pairs the kernels are built for; the fp32 kernel
# takes the equal ones
HEAD_DIMS = ((16, 16), (32, 32), (64, 64), (128, 128), (192, 128))
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
LAUNCHES = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, scale: float) -> torch.Tensor:
    """``softmax(q kᵀ · scale [causal]) v`` per head over ``q [H, Sq, dh]``,
    ``k [H, Sk, dh]`` and ``v [H, Sk, dv]``; returns ``[H, Sq, dv]``."""
    global LAUNCHES
    _build.check_operands("flash_attention", DTYPES, q, k, v)
    if q.ndim != 3 or k.ndim != 3 or v.ndim != 3 or \
            k.shape[:2] != v.shape[:2] or q.shape[0] != k.shape[0] or \
            q.shape[2] != k.shape[2]:
        raise ValueError(f"flash_attention: expected q [H, Sq, dh], k "
                         f"[H, Sk, dh] and v [H, Sk, dv], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    heads, sq, dh = q.shape
    sk, dv = v.shape[1:]
    if (dh, dv) not in HEAD_DIMS or (q.dtype == torch.float32 and dh != dv):
        raise ValueError(f"flash_attention: widths (dh {dh}, dv {dv}) not "
                         f"one of {HEAD_DIMS} (the fp32 kernel: dh = dv)")
    if sq < 1 or sk < 1:
        raise ValueError(f"flash_attention: empty sequence, Sq {sq}, Sk {sk}")
    q, k, v = (aligned16(t) for t in (q, k, v))
    out = q.new_empty((heads, sq, dv))
    _build.call(f"ndp_flash_attn_{_SUFFIX[q.dtype]}", q.data_ptr(),
                k.data_ptr(), v.data_ptr(), out.data_ptr(), heads, sq, sk, dh,
                dv, int(causal), scale * math.log2(math.e),
                torch.cuda.current_stream(q.device).cuda_stream)
    LAUNCHES += 1
    return out


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself if its data pointer is 16-byte aligned, else a copy in
    a fresh (aligned) allocation."""
    if t.data_ptr() % 16 == 0:
        return t
    copy = torch.empty_like(t)
    copy.copy_(t)
    return copy


def mma_smem_bytes(dh: int, dv: int) -> int:
    """Dynamic shared memory a block of the bf16 kernel takes at q·k depth
    ``dh`` and v width ``dv`` (q, and double-buffered K and V tiles)."""
    return _build.library("attention").ndp_flash_attn_bf16_smem_bytes(dh,
                                                                      dv)
