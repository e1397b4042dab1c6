"""Quickstart: programmer-transparent NDP offloading of a plain PyTorch
function.

You write ordinary PyTorch; Conduit's compile-time pass vectorizes it into
page-aligned SIMD instructions, and the runtime offloader schedules every
instruction across the SSD's three compute resources (controller cores,
in-DRAM compute, in-flash compute).

    PYTHONPATH=src python -m repro_torch.examples.quickstart
"""
import argparse

import numpy as np
import torch

from repro_torch.core.vectorize import vectorize
from repro_torch.device import resolve_device
from repro_torch.sim import simulate


def my_kernel(data, keys):
    """An ordinary PyTorch program: filter + checksum over a table."""
    mixed = (data ^ keys) + (data >> 3)
    mask = mixed > 0
    kept = torch.where(mask, mixed, 0)
    return torch.sum(kept), kept


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where the inputs are made (default: the GPU; "
                         "'cpu' runs without one)")
    device = resolve_device(ap.parse_args().device)
    rng = np.random.default_rng(0)
    data = torch.from_numpy(rng.integers(0, 2**30, size=(64, 16384),
                                         dtype=np.int32)).to(device)
    keys = torch.from_numpy(rng.integers(0, 2**30, size=(64, 16384),
                                         dtype=np.int32)).to(device)

    # 1. compile-time preprocessing (the paper's LLVM pass analogue)
    trace = vectorize(my_kernel, data, keys, name="quickstart")
    st = trace.characterize()
    print(f"vectorized into {st.total_instrs} page-aligned SIMD instructions"
          f" ({100*st.vectorizable_pct:.0f}% vectorizable, "
          f"bands L/M/H = {st.as_row()['low_pct']}/"
          f"{st.as_row()['medium_pct']}/{st.as_row()['high_pct']}%)")

    # 2. runtime offloading under different policies
    print(f"\n{'policy':14s} {'makespan':>12s} {'energy':>10s}  mix")
    base = None
    for pol in ("cpu", "isp", "pud", "dm", "bw", "conduit", "ideal"):
        r = simulate(trace, pol)
        base = base or r.makespan_ns
        mix = " ".join(f"{k.value}:{100*v:.0f}%"
                       for k, v in r.decision_mix().items() if v > 0.01)
        print(f"{pol:14s} {r.makespan_ns/1e6:10.2f}ms "
              f"{r.total_energy_nj/1e6:8.2f}mJ  {mix}"
              f"   ({base/r.makespan_ns:.2f}x vs cpu)")


if __name__ == "__main__":
    main()
