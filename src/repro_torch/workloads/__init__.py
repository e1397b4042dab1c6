"""The evaluated workloads (§5.4, Table 3) as traceable PyTorch programs.

Each workload module exposes ``make_fn(scale)`` (the PyTorch program),
``make_inputs(scale, seed, device)`` (its inputs, drawn from numpy's
``default_rng(seed)`` exactly as the JAX package draws them), ``SIM``
(simulator pressure knobs) and ``META`` (the paper's Table 3
characterization for comparison).  The port carries aes, xor_filter,
heat3d and jacobi1d; llama2_infer and llm_train follow in a later slice.

``get_trace`` runs Conduit's compile-time preprocessing on the workload;
``sim_config_for`` derives the per-workload capacity pressure (the paper
sizes footprints beyond capacity to induce movement, §5.4).

Entry points that touch tensors take ``device``; ``None`` means the GPU
(``"cuda"``) and raises when there is none — pass ``device="cpu"`` to run
on the CPU.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.core.trace import Trace
from repro_torch.core.vectorize import vectorize
from repro_torch.hw.ssd_spec import DEFAULT_SSD, SSDSpec
from repro_torch.sim.machine import SimConfig
from repro_torch.workloads import aes, heat3d, jacobi1d, xor_filter

WORKLOADS = {
    "aes": aes,
    "xor_filter": xor_filter,
    "heat3d": heat3d,
    "jacobi1d": jacobi1d,
}


def resolve_device(device: Optional[torch.device | str]) -> torch.device:
    """``None`` means the GPU; without one that is an error, never a
    quiet fall-back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda")
    return torch.device(device)


def make_inputs(name: str, scale: str = "paper", seed: int = 0,
                device: Optional[torch.device | str] = None):
    return WORKLOADS[name].make_inputs(scale, seed,
                                       device=resolve_device(device))


@functools.lru_cache(maxsize=32)
def _trace(name: str, scale: str, spec: SSDSpec, device: torch.device
           ) -> Trace:
    mod = WORKLOADS[name]
    fn = mod.make_fn(scale)
    args = mod.make_inputs(scale, device=device)
    kw = getattr(mod, "VECTORIZE_KW", {})
    return vectorize(fn, *args, spec=spec, name=name, **kw)


def get_trace(name: str, scale: str = "paper", spec: SSDSpec = DEFAULT_SSD,
              device: Optional[torch.device | str] = None) -> Trace:
    return _trace(name, scale, spec, resolve_device(device))


def sim_config_for(name: str, trace: Trace, pressure: float = 0.0,
                   **kw) -> SimConfig:
    """Simulator config for a workload.

    ``pressure=0`` (default): capacities fit the reduced-scale footprint —
    the paper's capacity effects exist at TB scale and adding artificial
    thrash cliffs at MB scale only injects noise.  ``pressure>0`` shrinks
    SSD-DRAM/host capacity to ``(1-pressure)`` of the footprint to exercise
    the eviction + lazy-coherence machinery (see the pressure benchmark).
    """
    mod = WORKLOADS[name]
    npages = len(trace.pages)
    keep = max(0.02, 1.0 - pressure)
    return SimConfig(
        dram_capacity_pages=max(32, int(keep * mod.SIM["dram_frac"] * npages)
                                if pressure else npages + 64),
        host_capacity_pages=max(32, int(keep * mod.SIM["host_frac"] * npages)
                                if pressure else npages + 64),
        **kw)


def run_numeric(name: str, scale: str = "tiny",
                device: Optional[torch.device | str] = None):
    """Execute the workload numerically (unquantized) — sanity oracle."""
    mod = WORKLOADS[name]
    fn = mod.make_fn(scale)
    args = mod.make_inputs(scale, device=resolve_device(device))
    return fn(*args)
