"""INT8 quantized matmul with INT32 accumulation on Hopper's tensor cores.

The paper quantizes every workload to INT8 (§5.4); the LLM workloads'
dominant compute is INT8 GEMM, ``int8[M, K] @ int8[K, N] -> int32[M, N]``.

Replaces the Pallas kernel ``repro/kernels/int8_matmul.py``
``_matmul_kernel`` (an MXU-tiled grid whose K axis accumulates into a
resident output block) with the CUDA kernel ``int8_matmul_mma_kernel`` of
``csrc/ndp.cu``: a block of 4 warps owns a (16 * MT) x 64 int32 tile
(MT = 3 at the LLM's 48 tokens) and walks its range of K in 128-byte
stages on ``mma.sync`` m16n8k32 ``.s8`` without ``.satfinite``, so the
int32 sums wrap.  B (``[K, N]``, N contiguous) is transposed in registers
with byte permutes into a swizzled shared tile of "4 k of one column"
words; A goes in as it lies.  Loads are 16 bytes wherever both pointers
are 16-byte aligned and K and N are multiples of 16, else a byte at a
time into the same tiles; two stages load while the current one
multiplies.  Where the output tiles leave most SMs idle and a split
shortens each block's walk of K by at least 6 stages, K is split into
ranges (``gridDim.z``); then ``out`` is zeroed and the partial tiles are
added with int32 atomics, exact in any order because int32 addition
wraps modulo 2**32.  Any M, N, K pass unpadded.  Bound on an H100 at the
LLM shapes: the bytes of B read once (PERF.md).

``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build

LAUNCHES = 0


def int8_matmul(a: torch.Tensor, b: torch.Tensor,
                splits: int = 0) -> torch.Tensor:
    """``a[int8, M, K] @ b[int8, K, N] -> int32[M, N]``, wrapping as int32
    sums do.  ``splits``: K ranges, 0 for the launcher's choice (what
    :func:`plan` reports)."""
    global LAUNCHES
    _build.check_operands("int8_matmul", (torch.int8,), a, b)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"int8_matmul: expected [M, K] and [K, N], got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    _build.call("ndp_int8_matmul", a.data_ptr(), b.data_ptr(),
                out.data_ptr(), m, n, k, splits,
                torch.cuda.current_stream(a.device).cuda_stream)
    LAUNCHES += 1
    return out


def plan(m: int, n: int, k: int, splits: int = 0) -> Dict[str, int]:
    """How the launcher cuts an ``[m, k] @ [k, n]`` call on the current
    device: K ranges, the output tile and the bytes of K a stage."""
    out = (ctypes.c_int * 4)()
    _build.library("ndp").ndp_int8_matmul_plan(m, n, k, splits, out)
    return {"splits": out[0], "tile_m": out[1], "tile_n": out[2],
            "stage_k": out[3]}
