"""heat-3d stencil workload (Polybench, §5.4 workload 3).

Three-dimensional 7-point heat-equation stencil iterated over time steps.
Fully auto-vectorizable (95% per Table 3); high data reuse across time
steps (reuse ~16); 60% medium (adds) / 40% high (multiplies) latency mix.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

SCALES = {
    "tiny": dict(n=16, tsteps=2),
    "paper": dict(n=64, tsteps=10),
}


def _step(u):
    c = u[1:-1, 1:-1, 1:-1]
    ddx = u[2:, 1:-1, 1:-1] - c * 2 + u[:-2, 1:-1, 1:-1]
    ddy = u[1:-1, 2:, 1:-1] - c * 2 + u[1:-1, :-2, 1:-1]
    ddz = u[1:-1, 1:-1, 2:] - c * 2 + u[1:-1, 1:-1, :-2]
    upd = c + ddx * 41 + ddy * 41 + ddz * 41   # INT8-quantized 0.125-scale
    return F.pad(upd, (1, 1, 1, 1, 1, 1))


def make_fn(scale: str = "paper"):
    p = SCALES[scale]

    def heat3d(u):
        for _ in range(p["tsteps"]):
            u = _step(u)
        return u

    return heat3d


def make_inputs(scale: str = "paper", seed: int = 0,
                device: torch.device | str = "cuda"):
    p = SCALES[scale]
    rng = np.random.default_rng(seed)
    n = p["n"]
    u = torch.from_numpy(
        rng.integers(-64, 64, size=(n, n, n), dtype=np.int32)).to(device)
    return (u,)


SIM = dict(dram_frac=0.5, host_frac=0.4)
META = dict(paper_vect=95, paper_reuse=16, paper_low=0, paper_med=60,
            paper_high=40, kind="compute_intensive")
