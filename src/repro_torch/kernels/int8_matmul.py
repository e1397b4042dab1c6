"""INT8 quantized matmul with INT32 accumulation on Hopper.

The paper quantizes every workload to INT8 (§5.4); the LLM workloads'
dominant compute is INT8 GEMM, ``int8[M, K] @ int8[K, N] -> int32[M, N]``.

Replaces the Pallas kernel ``repro/kernels/int8_matmul.py``
``_matmul_kernel`` (an MXU-tiled grid whose K axis accumulates into a
resident output block) with the CUDA kernel ``int8_matmul_kernel`` of
``csrc/ndp.cu``: a block of 256 threads keeps a 16 x 64 int32 output tile
in registers and walks K in 128-byte stages through shared memory, four
int8 products per ``__dp4a``.  Every load is masked, so any M, N, K pass
unpadded.  Bound on an H100 at the LLM shapes: the bytes of the operands
(PERF.md); this first form is not near it.

``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

LAUNCHES = 0


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a[int8, M, K] @ b[int8, K, N] -> int32[M, N]``, wrapping as int32
    sums do."""
    global LAUNCHES
    _build.check_operands("int8_matmul", (torch.int8,), a, b)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"int8_matmul: expected [M, K] and [K, N], got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    _build.call("ndp_int8_matmul", a.data_ptr(), b.data_ptr(),
                out.data_ptr(), m, n, k,
                torch.cuda.current_stream(a.device).cuda_stream)
    LAUNCHES += 1
    return out
