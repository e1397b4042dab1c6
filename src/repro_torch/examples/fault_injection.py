"""Watching the drive survive: the recovery ladder in the flight recorder.

``benchmarks/run.py --only faults`` quantifies what injected bit errors
cost a serving drive; this walkthrough shows *how you see the recovery
happen*.  One serving run is executed with the error model armed
(``FaultConfig``) and telemetry on: reads whose hard-decode fails climb
the recovery ladder — retry re-senses at escalating sense levels, a
soft-decode on the shared ECC engines, superpage-parity rebuild — and
every rung books real time on real resources, so it is all visible in
the exported Perfetto trace:

1. the **"reliability" process** — per-die ``recovery:<stage>`` spans
   (retry / soft-decode / rebuild), ``retire b<N>`` relocation spans,
   and instant markers where a die fails or degrades to read-only;
2. the **offload-decision audit stream** — decisions that landed on a
   die whose recovery ladder was still busy carry
   ``mid_recovery=True``: the queue-depth features the policy weighed
   included recovery work, not just useful work;
3. the usual fabric/session/host-I/O tracks underneath, so a recovery
   span sits directly above the host read it delayed.

Mid-run, one whole die is killed (``die_failures``) — every subsequent
read on it reconstructs from superpage parity, a rebuild fan-out you
can see as parallel sibling senses.

The script exports the trace, then *programmatically* reads the story a
human would read in the Perfetto UI: host reads that landed while their
die was mid-recovery wait behind the ladder, so their latencies spike —
the error-induced tail.

    PYTHONPATH=src python -m repro_torch.examples.fault_injection
    PYTHONPATH=src python -m repro_torch.examples.fault_injection --smoke \\
        --out /tmp/faults_trace.json

Open the exported JSON at https://ui.perfetto.dev: the "reliability"
process holds the per-die recovery tracks; zoom to any
``recovery:rebuild`` span and look at the parallel flash sense spans on
the sibling dies below it.
"""
import argparse

from repro_torch.sim import (CatalogEntry, FaultConfig, FTLConfig,
                             HostIOStream, PoissonArrivals, ServingConfig,
                             SessionCatalog, TelemetryConfig, simulate_serving,
                             summarize_trace)
from repro_torch.workloads import get_trace

#: RBER at the hard-decode limit: most reads ladder but recover in the
#: retry/soft rungs — lots of visible recovery, few uncorrectables
LADDER_RBER = 1.2e-3
#: the die killed mid-run and the simulated time it dies at
DEAD_DIE, DIE_FAILS_AT_NS = 3, 2.0e5


def run(smoke: bool = False, device=None):
    catalog = SessionCatalog(
        [CatalogEntry("jacobi1d",
                      get_trace("jacobi1d", "tiny", device=device),
                      weight=3.0),
         CatalogEntry("xor_filter",
                      get_trace("xor_filter", "tiny", device=device),
                      weight=1.0)],
        seed=5)
    # the serving-drive geometry from repro_torch.examples.tracing_walkthrough,
    # read-heavier so the error model gets plenty of sense operations
    ftl = FTLConfig(blocks_per_die=4, pages_per_block=8, op_ratio=0.28,
                    prefill=0.9, gc_reserve_blocks=1)
    io = HostIOStream(rate_iops=60_000, read_fraction=0.7,
                      n_requests=96 if smoke else 384, zipf_theta=0.95,
                      n_logical_pages=ftl.logical_pages())
    arrivals = PoissonArrivals(rate_per_sec=6000,
                               n_sessions=16 if smoke else 48, seed=9)
    faults = FaultConfig(rber_base=LADDER_RBER,
                         die_failures=((DEAD_DIE, DIE_FAILS_AT_NS),))
    tele = TelemetryConfig(spans=True, audit=True, interval_ns=20_000.0)
    res = simulate_serving(
        catalog, arrivals, "conduit",
        serving=ServingConfig(keep_session_results=False,
                              warmup_ns=1e5, cooldown_ns=1e5,
                              little_law_warn_tol=float("inf")),
        io_stream=io, ftl=ftl, faults=faults, telemetry=tele)
    return res


def recovery_tail_story(trace) -> str:
    """Read the error-induced tail out of the exported trace, per die:
    host requests whose lifetime overlaps a recovery span on their die
    vs the rest."""
    from repro_torch.sim.telemetry import PID_RELIABILITY

    tname = {}
    for ev in trace["traceEvents"]:
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            tname[(ev["pid"], ev["tid"])] = ev["args"]["name"]
    rec_by_die = {}
    stages = {}
    for ev in trace["traceEvents"]:
        if ev.get("ph") == "X" and ev.get("pid") == PID_RELIABILITY \
                and ev["name"].startswith("recovery:"):
            die = int(tname[(ev["pid"], ev["tid"])][len("die"):])
            rec_by_die.setdefault(die, []).append(
                (ev["ts"], ev["ts"] + ev["dur"]))
            stage = ev["name"][len("recovery:"):]
            stages[stage] = stages.get(stage, 0) + 1
    opens = {}
    ios = []                       # (die, t0, t1)
    for ev in trace["traceEvents"]:
        if ev.get("cat") != "host_io":
            continue
        if ev["ph"] == "b":
            opens[ev["id"]] = (ev["args"]["die"], ev["ts"])
        else:
            die, t0 = opens.pop(ev["id"])
            ios.append((die, t0, ev["ts"]))
    hit = []                       # (latency, die) — overlapped a recovery
    clear = []
    for die, t0, t1 in ios:
        spans = rec_by_die.get(die, ())
        if any(r0 < t1 and t0 < r1 for r0, r1 in spans):
            hit.append((t1 - t0, die))
        else:
            clear.append((t1 - t0, die))
    if not hit or not clear:
        return "  (no recovery/host-IO overlap in this run)"
    lat, die = max(hit)
    mean = lambda xs: sum(x for x, _ in xs) / len(xs)
    by_stage = ", ".join(f"{n} {s}" for s, n in sorted(stages.items()))
    lines = [
        f"  {sum(stages.values())} recovery spans in the trace "
        f"({by_stage})",
        f"  {len(hit)} of {len(hit) + len(clear)} host requests ran while "
        f"their die was recovering:",
        f"    mean latency {mean(clear):8.1f} us when the die was clear",
        f"    mean latency {mean(hit):8.1f} us when caught mid-recovery "
        f"(worst {lat:.0f} us on die {die})",
        f"  -> in Perfetto, find the recovery span on reliability/die{die} "
        f"and the io:* span\n     stretched underneath it — that stretch "
        f"IS the error-induced tail",
    ]
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run (fewer sessions / host requests)")
    ap.add_argument("--out", default="faults_trace.json",
                    help="trace output path (default: %(default)s)")
    ap.add_argument("--device", default=None,
                    help="where the traces are made (default: the GPU; "
                         "'cpu' runs without one)")
    args = ap.parse_args()

    print("== serving with the error model armed, flight recorder on")
    res = run(smoke=args.smoke, device=args.device)
    st = res.faults
    rec = res.telemetry
    trace = rec.export(args.out)
    s = summarize_trace(trace)
    print(f"  {res.n_completed} sessions served; {st.summary()}")
    print(f"  {s['n_events']} trace events "
          f"({s['spans_by_process'].get('reliability', 0)} reliability "
          f"spans, {s['n_audit']} audited decisions)")
    print(f"  trace written to {args.out} — open it at "
          f"https://ui.perfetto.dev\n")

    print("== the error-induced tail, read from the trace (times in us)")
    print(recovery_tail_story(trace))

    worst = max(range(len(st.errors_by_die)), key=st.errors_by_die.__getitem__)
    print(f"\n== per-die error counters: die {worst} leads with "
          f"{st.errors_by_die[worst]} hard fails "
          f"(die {DEAD_DIE} failed outright at "
          f"t={DIE_FAILS_AT_NS/1e3:.0f} us; its reads rebuild from parity)")

    mid = [a for a in rec.audit if a.mid_recovery]
    if mid:
        print(f"\n== {len(mid)} offload decisions landed mid-recovery; "
              f"the first, explained:")
        print(mid[0].explain())
    else:
        print("\n== no offload decision landed mid-recovery in this run")


if __name__ == "__main__":
    main()
