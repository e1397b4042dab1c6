"""Open-loop serving: from batch makespan to sustainable throughput.

The paper evaluates one offloaded program at a time, and `simulate_mix`
measures the makespan of a fixed tenant set.  A production drive is
judged differently: sessions keep arriving whether or not earlier ones
finished (open loop), and the question is how many sessions per second
the SSD sustains *while keeping tail latency bounded*.  This demo walks
the three pieces of the serving subsystem:

1. a weighted session catalog (3x short jacobi1d : 1x longer xor_filter)
   with Poisson arrivals — the latency-throughput "hockey stick" per
   offloading policy: flat at low load, a knee, then a queueing cliff;
2. the same load as ON/OFF bursts (a 2-state MMPP at the *same* mean
   rate) — burstiness alone inflates the tail;
3. `find_saturation` — a deterministic bisection for the max sustainable
   sessions/sec under a p99 latency SLO, per policy: one number that
   ranks conduit against the BW/DM baselines in the serving regime.

    PYTHONPATH=src python -m repro_torch.examples.open_loop_serving
"""
import argparse

from repro_torch.sim import (CatalogEntry, MMPPArrivals, PoissonArrivals,
                             ServingConfig, SessionCatalog, find_saturation,
                             simulate_serving)
from repro_torch.workloads import get_trace


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where the traces are made (default: the GPU; "
                         "'cpu' runs without one)")
    device = ap.parse_args().device
    catalog = SessionCatalog(
        [CatalogEntry("jacobi1d",
                      get_trace("jacobi1d", "tiny", device=device),
                      weight=3.0),
         CatalogEntry("xor_filter",
                      get_trace("xor_filter", "tiny", device=device),
                      weight=1.0)],
        seed=5)
    n = 96
    scfg = ServingConfig(warmup_ns=0.6e6, cooldown_ns=0.6e6,
                         keep_session_results=False)

    print("== the hockey stick (conduit policy, poisson arrivals)")
    print(f"  {'offered/s':>10s} {'completed/s':>12s} {'p50':>9s} "
          f"{'p99':>9s} {'rej':>4s} {'busiest util':>13s}")
    for rate in (1000, 2000, 4000, 8000, 16000, 24000):
        arr = PoissonArrivals(rate_per_sec=rate, n_sessions=n, seed=9)
        r = simulate_serving(catalog, arr, "conduit", serving=scfg)
        print(f"  {rate:>10,d} {r.completed_rate_per_sec:>12,.0f} "
              f"{r.p(50)/1e3:>7.1f}us {r.p(99)/1e3:>7.1f}us "
              f"{r.n_rejected:>4d} {max(r.utilization.values()):>13.3f}")

    print("\n== burstiness at the same mean rate (8k sessions/s)")
    smooth = PoissonArrivals(rate_per_sec=8000, n_sessions=n, seed=9)
    bursty = MMPPArrivals(rate_on_per_sec=32_000, rate_off_per_sec=0.0,
                          mean_on_ns=2e6, mean_off_ns=6e6,
                          n_sessions=n, seed=9)
    for name, arr in (("poisson", smooth), ("mmpp on/off", bursty)):
        r = simulate_serving(catalog, arr.at_rate(8000), "conduit",
                             serving=scfg)
        print(f"  {name:12s} p50={r.p(50)/1e3:7.1f}us "
              f"p99={r.p(99)/1e3:8.1f}us  "
              f"mean_in_system={r.mean_in_system:5.2f}  "
              f"little_ratio={r.little_law_ratio():5.3f}")

    print("\n== saturation point per policy (p99 SLO 1.5 ms, bisection)")
    for pol in ("conduit", "bw", "dm"):
        sat = find_saturation(catalog, pol, slo_p99_ns=1.5e6,
                              rate_lo=1000, rate_hi=24_000, iters=5,
                              n_sessions=n, seed=9, serving=scfg)
        print(f"  {pol:8s} sustains {sat.rate_per_sec:>9,.0f} sessions/s "
              f"(bracket {sat.bracket[0]:,.0f}..{sat.bracket[1]:,.0f}, "
              f"{len(sat.probes)} probes)")


if __name__ == "__main__":
    main()
