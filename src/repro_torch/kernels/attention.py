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
top-left, as the TPU kernel's; any Sq and Sk pass unpadded.  Both kernels
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
HEAD_DIMS = (16, 32, 64, 128)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
LAUNCHES = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, scale: float) -> torch.Tensor:
    """``softmax(q kᵀ · scale [causal]) v`` per head over ``q [H, Sq, dh]``
    and ``k, v [H, Sk, dh]``."""
    global LAUNCHES
    _build.check_operands("flash_attention", DTYPES, q, k, v)
    if q.ndim != 3 or k.shape != v.shape or k.ndim != 3 or \
            q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"flash_attention: expected q [H, Sq, dh] and k, v "
                         f"[H, Sk, dh], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    heads, sq, dh = q.shape
    sk = k.shape[1]
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {dh} not one of "
                         f"{HEAD_DIMS}")
    if sq < 1 or sk < 1:
        raise ValueError(f"flash_attention: empty sequence, Sq {sq}, Sk {sk}")
    q, k, v = (aligned16(t) for t in (q, k, v))
    out = torch.empty_like(q)
    _build.call(f"ndp_flash_attn_{_SUFFIX[q.dtype]}", q.data_ptr(),
                k.data_ptr(), v.data_ptr(), out.data_ptr(), heads, sq, sk, dh,
                int(causal), scale * math.log2(math.e),
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


def mma_smem_bytes(dh: int) -> int:
    """Dynamic shared memory a block of the bf16 kernel takes at head dim
    ``dh`` (q, and double-buffered K and V tiles)."""
    return _build.library("attention").ndp_flash_attn_bf16_smem_bytes(dh)
