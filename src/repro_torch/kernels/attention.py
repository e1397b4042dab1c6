"""Attention with an online softmax on Hopper (the LM prefill path).

Replaces the Pallas kernel ``repro/kernels/attention.py`` ``_attn_kernel``
(grid (heads, q-blocks); one q tile in VMEM, k/v tiles streamed with a
running (max, normaliser, accumulator), no ``[Sq, Sk]`` score matrix) with
the CUDA kernel ``flash_attn_kernel`` of ``csrc/attention.cu``: a block of
256 threads owns one head and a tile of q rows, a row split over dh / 16
lanes, K/V tiles streamed through shared memory as fp32, eight keys scored
per rescale.  fp32 arithmetic throughout, output in q's type; the causal
mask is ``q_pos >= k_pos`` aligned top-left, as the TPU kernel's; any Sq
and Sk pass unpadded.  Bound on an H100 at the serving shape: the bytes of
q, k, v and out; this first form runs on the CUDA cores and is held by
their fp32 rate (PERF.md).

``LAUNCHES`` counts kernel launches.
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
    out = torch.empty_like(q)
    _build.call(f"ndp_flash_attn_{_SUFFIX[q.dtype]}", q.data_ptr(),
                k.data_ptr(), v.data_ptr(), out.data_ptr(), heads, sq, sk, dh,
                int(causal), scale * math.log2(math.e),
                torch.cuda.current_stream(q.device).cuda_stream)
    LAUNCHES += 1
    return out
