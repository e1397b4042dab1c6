"""Mamba2's selective scan: every time step of one ``mamba_apply`` call in
one launch.

Replaces no Pallas kernel: the JAX package runs the recurrence as
``jax.lax.scan`` (``repro/models/ssm.py:87``).  The CUDA kernel
``selective_scan_kernel`` of ``csrc/scan.cu`` keeps each (batch row,
channel)'s N fp32 states in one thread's registers over the whole
sequence, streaming dt, u, B and C through shared memory in tiles of 8
steps; it is bound by those bytes and the fp32 fmas (PERF.md).
:func:`selective_scan_plain` is the same recurrence as a Python loop over
the steps, with the reference's order of operations: the port's only
such loop for Mamba2, which trains through it.

Operands, all fp32: ``dt``, ``u`` [B, S, di]; ``bmat``, ``cmat`` [B, S, N]
(any batch and step stride, the last stride 1: a view of the fused
projection is read in place); ``a`` [di]; ``h0`` [B, di, N].  Returns
fresh ``y`` [B, S, di] and the last state ``h`` [B, di, N], written into
``h_out`` where one is given (which may be ``h0``: a decode step's state
updated in place).

``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

STATES = (16, 32, 64)           # the N the kernel is built for
MAX_BATCH = 65535               # gridDim.y
LAUNCHES = 0


def selective_scan(dt: torch.Tensor, u: torch.Tensor, bmat: torch.Tensor,
                   cmat: torch.Tensor, a: torch.Tensor, h0: torch.Tensor,
                   h_out: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan on the card: one launch of ``csrc/scan.cu``; the last
    state into ``h_out`` (contiguous, 16-byte aligned) where given."""
    global LAUNCHES
    if not all(t.is_cuda for t in (dt, u, bmat, cmat, a, h0)):
        raise ValueError("selective_scan: expected CUDA tensors")
    b, s, di = dt.shape
    n = bmat.shape[2]
    if n not in STATES:
        raise ValueError(f"selective_scan: state size {n} not one of "
                         f"{STATES}")
    if b > MAX_BATCH:
        raise ValueError(f"selective_scan: batch {b} over {MAX_BATCH}")
    dt, u, a, h0 = (t.contiguous() for t in (dt, u, a, h0))
    bmat, cmat = (t if t.stride(2) == 1 else t.contiguous()
                  for t in (bmat, cmat))
    if h_out is None:
        h = torch.empty((b, di, n), dtype=torch.float32, device=dt.device)
    elif not h_out.is_contiguous() or h_out.data_ptr() % 16:
        raise ValueError("selective_scan: h_out must be contiguous and "
                         "16-byte aligned")
    else:
        h = h_out
    if h0.data_ptr() % 16:
        h0 = h0.clone()
    y = torch.empty_like(dt)
    _build.call("ndp_selective_scan_f32", dt.data_ptr(), u.data_ptr(),
                bmat.data_ptr(), cmat.data_ptr(), a.data_ptr(),
                h0.data_ptr(), y.data_ptr(), h.data_ptr(), b, s, di, n,
                bmat.stride(0), bmat.stride(1), cmat.stride(0),
                cmat.stride(1),
                torch.cuda.current_stream(dt.device).cuda_stream)
    LAUNCHES += 1
    return y, h


def selective_scan_plain(dt: torch.Tensor, u: torch.Tensor,
                         bmat: torch.Tensor, cmat: torch.Tensor,
                         a: torch.Tensor, h0: torch.Tensor,
                         steps: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan as a loop over the steps, each step a few tensor ops in
    the reference's order: the version the kernel is held to, and the
    path of ``models/ssm.py`` where autograd records or on DTensors.
    ``steps`` computes only the first ``steps`` steps, the skipped ones
    repeating the last output (the dry-run's shortened scans)."""
    s = dt.shape[1]
    h = h0
    ys = []
    for t in range(s if steps is None else steps):
        dt_t = dt[:, t]
        decay = torch.exp(dt_t * a)                           # [B,di]
        h = h * decay[..., None] + (dt_t * u[:, t])[..., None] * \
            bmat[:, t, None, :]
        ys.append((h * cmat[:, t, None, :]).sum(-1))          # [B,di]
    return torch.stack(ys + [ys[-1]] * (s - len(ys)), dim=1), h
