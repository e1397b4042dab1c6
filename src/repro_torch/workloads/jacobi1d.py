"""jacobi-1d stencil workload (Polybench, §5.4 workload 4).

One-dimensional 3-point Jacobi smoother.  Table 3: 95% vectorizable,
reuse 3, 67% medium / 33% high — exactly two adds and one multiply per
point per sweep.
"""
from __future__ import annotations

import numpy as np
import torch

SCALES = {
    "tiny": dict(n=16 * 4096, tsteps=2),
    "paper": dict(n=160 * 4096, tsteps=3),
}


def make_fn(scale: str = "paper"):
    p = SCALES[scale]

    def jacobi1d(a, b):
        for _ in range(p["tsteps"]):
            b = (a[:-2] + a[1:-1] + a[2:]) * 85          # INT8 1/3-scale
            a = torch.cat([a[:1], b, a[-1:]])
        return a

    return jacobi1d


def make_inputs(scale: str = "paper", seed: int = 0,
                device: torch.device | str = "cuda"):
    p = SCALES[scale]
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(
        rng.integers(-64, 64, size=(p["n"],), dtype=np.int32)).to(device)
    b = torch.from_numpy(
        rng.integers(-64, 64, size=(p["n"] - 2,), dtype=np.int32)).to(device)
    return (a, b)


SIM = dict(dram_frac=0.4, host_frac=0.35)
META = dict(paper_vect=95, paper_reuse=3, paper_low=0, paper_med=67,
            paper_high=33, kind="compute_intensive")
