"""Serving on a fleet of drives: finding the straggler in a merged trace.

``benchmarks/run.py --only fleet`` quantifies what placement, read
steering and hedging buy at rack scale; this walkthrough shows *how you
see the straggler*.  A three-drive fleet serves one open-loop session
stream behind hash placement with two replicas per session — and drive 0
carries a write-heavy host stream on a tight FTL, so it is collecting
garbage the whole run.  Every drive records its own flight-recorder
timeline; the per-drive traces are merged into one fleet trace
(:func:`repro_torch.sim.telemetry.export_fleet_trace`) whose process tracks
carry ``d<drive>:`` prefixes (``d0:fabric``, ``d2:sessions``, ...).

The script then reads the story a human would read in the Perfetto UI —
*from the exported JSON file*, not from live objects:

1. :func:`repro_torch.sim.telemetry.validate_trace` checks the merged
   envelope, the drive-prefixed process vocabulary, span balance;
2. :func:`repro_torch.sim.analysis.fleet_blame` splits the merged trace back
   into per-drive timelines, computes the *sample-merged* fleet p99
   (never an average of per-drive p99s), and names the drive with the
   largest share of the fleet's tail sessions — plus the component
   (queueing, flash, GC stall...) that built that tail;
3. a second run with read steering on shows the same fleet routing
   around the collecting drive: the fleet p99 drops back to healthy.

    PYTHONPATH=src python -m repro_torch.examples.fleet_serving
    PYTHONPATH=src python -m repro_torch.examples.fleet_serving --smoke \\
        --out /tmp/fleet_trace.json

Open the exported JSON at https://ui.perfetto.dev: three stacked drive
timelines, and drive 0's ``d0:ftl-gc`` track solid with collection while
its ``d0:sessions`` spans stretch.
"""
import argparse
import json

from repro_torch.sim import (CatalogEntry, FleetConfig, DriveProfile,
                             FTLConfig, HostIOStream, PoissonArrivals,
                             ServingConfig, SessionCatalog, TelemetryConfig,
                             export_fleet_trace, fleet_blame, simulate_fleet,
                             validate_trace)
from repro_torch.workloads import get_trace

N_DRIVES = 3


def _fleet(steering: bool, smoke: bool) -> FleetConfig:
    # drive 0 is the straggler: write-heavy churn on a tight FTL keeps
    # its garbage collector busy for the whole serving window
    ftl = FTLConfig(blocks_per_die=4, pages_per_block=8, op_ratio=0.28,
                    prefill=0.9, gc_suspend=True, gc_reserve_blocks=1)
    churn = HostIOStream(rate_iops=150_000, read_fraction=0.1,
                         n_requests=400 if smoke else 1200,
                         zipf_theta=0.9, n_logical_pages=ftl.logical_pages(),
                         seed=11)
    return FleetConfig(n_drives=N_DRIVES, placement="hash", replication=2,
                       steering=steering,
                       profiles=((0, DriveProfile(io_stream=churn, ftl=ftl)),))


def run(steering: bool, smoke: bool, telemetry=None, device=None):
    catalog = SessionCatalog(
        [CatalogEntry("jacobi1d",
                      get_trace("jacobi1d", "tiny", device=device),
                      weight=3.0),
         CatalogEntry("xor_filter",
                      get_trace("xor_filter", "tiny", device=device),
                      weight=1.0)],
        seed=5)
    arrivals = PoissonArrivals(rate_per_sec=6000,
                               n_sessions=24 if smoke else 64, seed=9)
    return simulate_fleet(
        catalog, arrivals, "conduit",
        serving=ServingConfig(keep_session_results=False,
                              warmup_ns=1e5, cooldown_ns=1e5,
                              little_law_warn_tol=float("inf")),
        fleet=_fleet(steering, smoke), telemetry=telemetry)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run (fewer sessions / host requests)")
    ap.add_argument("--out", default="fleet_trace.json",
                    help="merged trace output path (default: %(default)s)")
    ap.add_argument("--device", default=None,
                    help="where the traces are made (default: the GPU; "
                         "'cpu' runs without one)")
    args = ap.parse_args()

    print(f"== {N_DRIVES}-drive fleet, hash placement, replication=2, "
          f"drive 0 mid-GC, recorders on")
    res = run(steering=False, smoke=args.smoke,
              telemetry=TelemetryConfig(spans=True, audit=True,
                                        interval_ns=20_000.0),
              device=args.device)
    print(f"  fleet p99 {res.p(99) / 1e3:8.1f} us   per-drive p99 "
          + "  ".join(f"d{d}={p / 1e3:.1f}us"
                      for d, p in enumerate(res.per_drive_p(99))))
    export_fleet_trace(res.telemetry, args.out)
    print(f"  merged trace written to {args.out} — open it at "
          f"https://ui.perfetto.dev")

    # everything below reads the exported FILE: the analysis layer needs
    # nothing but the JSON a colleague (or CI artifact) would hand you
    with open(args.out) as f:
        trace = json.load(f)
    errors = validate_trace(trace)
    print(f"\n== validate_trace: {len(errors)} errors"
          + ("" if not errors else f" — first: {errors[0]}"))
    assert not errors, errors

    blame = fleet_blame(trace)
    print(f"== fleet_blame (fleet p99 = sample-merged "
          f"{blame['fleet_p99_ns'] / 1e3:.1f} us)")
    for row in blame["per_drive"]:
        print(f"  drive {row['drive']}: {row['n_sessions']:3d} sessions  "
              f"p99={row['p99_ns'] / 1e3:8.1f}us  "
              f"tail={row['tail_sessions']:2d} "
              f"({row['tail_share']:.0%})  "
              f"dominant={row['dominant_component']}")
    s = blame["straggler"]
    print(f"  -> straggler: drive {s['drive']} with {s['tail_share']:.0%} "
          f"of the fleet tail, built by '{s['dominant_component']}'")

    print(f"\n== same fleet, read steering ON (collecting drive sinks to "
          f"the back of every preference order)")
    res2 = run(steering=True, smoke=args.smoke, device=args.device)
    print(f"  fleet p99 {res2.p(99) / 1e3:8.1f} us   "
          f"({res2.n_steered} sessions steered; was "
          f"{res.p(99) / 1e3:.1f} us unsteered)")


if __name__ == "__main__":
    main()
