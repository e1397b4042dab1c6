"""Reading a GC-induced tail with the flight recorder.

:mod:`repro_torch.examples.gc_policies` quantifies what garbage collection
costs a serving drive; this walkthrough shows *how you see it happen*.  One
serving-under-GC run is re-executed with telemetry on
(``telemetry=TelemetryConfig(...)``), which produces, at zero change to
the simulated results (the telemetry-on golden law in
``tests/test_telemetry.py``):

1. a **Perfetto/Chrome trace** — one track per die/channel/compute unit,
   GC cycle/copy/erase spans per die, session and host-I/O lifecycle
   spans, and counter tracks from the interval sampler;
2. the **offload-decision audit stream** — per dispatch, the six cost
   features for every candidate resource and the chosen one;
3. **interval metrics** — utilization, queue depth, GC-busy dies,
   serving backlog, sliding p99.

The script exports the trace, then *programmatically* reads the story a
human would read in the Perfetto UI: host requests that land on a die
while its collector is mid-cycle wait behind the copies, so their
latencies spike — the GC-induced tail.  It ends by asking the audit
stream to explain one offloading decision end-to-end.

    PYTHONPATH=src python -m repro_torch.examples.tracing_walkthrough
    PYTHONPATH=src python -m repro_torch.examples.tracing_walkthrough \\
        --smoke --out /tmp/serving_gc_trace.json

Open the exported JSON at https://ui.perfetto.dev (or
``chrome://tracing``): the "ftl-gc" process holds the per-die GC tracks,
"fabric" the per-unit booking tracks, "host-io"/"sessions" the async
lifecycle spans, "metrics" the counter tracks.  Zoom to any ``gc-cycle``
span and look at the ``flash_dies`` track below it.
"""
import argparse

from repro_torch.sim import (CatalogEntry, FTLConfig, HostIOStream,
                             PoissonArrivals, ServingConfig, SessionCatalog,
                             TelemetryConfig, simulate_serving,
                             summarize_trace)
from repro_torch.workloads import get_trace


def run(smoke: bool = False, device=None):
    catalog = SessionCatalog(
        [CatalogEntry("jacobi1d",
                      get_trace("jacobi1d", "tiny", device=device),
                      weight=3.0),
         CatalogEntry("xor_filter",
                      get_trace("xor_filter", "tiny", device=device),
                      weight=1.0)],
        seed=5)
    # the serving-drive geometry from repro_torch.examples.gc_policies: small
    # blocks on the full drive keep every die's collector busy
    ftl = FTLConfig(blocks_per_die=4, pages_per_block=8, op_ratio=0.28,
                    prefill=0.9, gc_reserve_blocks=1)
    io = HostIOStream(rate_iops=60_000, read_fraction=0.3,
                      n_requests=96 if smoke else 384, zipf_theta=0.95,
                      n_logical_pages=ftl.logical_pages())
    arrivals = PoissonArrivals(rate_per_sec=6000,
                               n_sessions=16 if smoke else 48, seed=9)
    tele = TelemetryConfig(spans=True, audit=True, interval_ns=20_000.0)
    res = simulate_serving(
        catalog, arrivals, "conduit",
        serving=ServingConfig(keep_session_results=False,
                              warmup_ns=1e5, cooldown_ns=1e5,
                              # overlap, not steady state, is the subject
                              little_law_warn_tol=float("inf")),
        io_stream=io, ftl=ftl, telemetry=tele)
    return res


def gc_tail_story(trace) -> str:
    """Read the GC-induced tail out of the exported trace, per die: host
    requests whose lifetime overlaps a GC cycle on their die vs the rest."""
    from repro_torch.sim.telemetry import PID_FTL

    pname = {}
    tname = {}
    for ev in trace["traceEvents"]:
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            tname[(ev["pid"], ev["tid"])] = ev["args"]["name"]
    gc_by_die = {}
    for ev in trace["traceEvents"]:
        if ev.get("ph") == "X" and ev.get("pid") == PID_FTL \
                and ev["name"].startswith("gc-cycle"):
            die = int(tname[(ev["pid"], ev["tid"])][len("die"):])
            gc_by_die.setdefault(die, []).append(
                (ev["ts"], ev["ts"] + ev["dur"]))
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
    hit = []                       # (latency, die) — overlapped own-die GC
    clear = []
    for die, t0, t1 in ios:
        cycles = gc_by_die.get(die, ())
        if any(g0 < t1 and t0 < g1 for g0, g1 in cycles):
            hit.append((t1 - t0, die))
        else:
            clear.append((t1 - t0, die))
    if not hit or not clear:
        return "  (no GC/host-IO overlap in this run — rerun without --smoke)"
    lat, die = max(hit)
    mean = lambda xs: sum(x for x, _ in xs) / len(xs)
    lines = [
        f"  {len(hit)} of {len(hit) + len(clear)} host requests ran while "
        f"their die was collecting:",
        f"    mean latency {mean(clear):8.1f} us when the die was clear",
        f"    mean latency {mean(hit):8.1f} us when caught mid-GC "
        f"(worst {lat:.0f} us on die {die})",
        f"  -> in Perfetto, find the gc-cycle span on ftl-gc/die{die} and "
        f"the io:* span\n     stretched underneath it — that stretch IS "
        f"the GC-induced tail",
    ]
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run (fewer sessions / host requests)")
    ap.add_argument("--out", default="serving_gc_trace.json",
                    help="trace output path (default: %(default)s)")
    ap.add_argument("--device", default=None,
                    help="where the traces are made (default: the GPU; "
                         "'cpu' runs without one)")
    args = ap.parse_args()

    print("== serving under GC, flight recorder on")
    res = run(smoke=args.smoke, device=args.device)
    rec = res.telemetry
    trace = rec.export(args.out)
    s = summarize_trace(trace)
    print(f"  {res.n_completed} sessions served, "
          f"{rec.event_counts.get('gc', 0)} GC cycles, "
          f"{s['n_events']} trace events "
          f"({s['spans_by_process'].get('fabric', 0)} fabric spans, "
          f"{s['spans_by_process'].get('ftl-gc', 0)} GC spans, "
          f"{s['n_audit']} audited decisions, "
          f"{s['n_intervals']} interval samples)")
    print(f"  trace written to {args.out} — open it at "
          f"https://ui.perfetto.dev\n")

    print("== the GC-induced tail, read from the trace (times in us)")
    print(gc_tail_story(trace))

    print("\n== one offloading decision, explained by the audit stream")
    # pick a dispatch that had a real choice: the widest total_ns spread
    # among supported candidates
    def spread(a):
        tot = [c.total_ns for c in a.candidates if c.supported]
        return (max(tot) - min(tot)) if len(tot) > 1 else -1.0
    audit = max(rec.audit, key=spread)
    print(audit.explain())

    print("\n== interval metrics: when GC was busiest")
    busiest = max(rec.intervals, key=lambda s: s.gc_active_dies)
    print(f"  t={busiest.t_ns/1e3:.0f}us: {busiest.gc_active_dies} dies "
          f"collecting, backlog={busiest.backlog}, "
          f"active={busiest.active_sessions}, "
          f"window p99={busiest.p99_op_ns/1e3:.1f}us")

    print("\n== tail-latency blame: the analysis layer names the tail")
    # no more eyeballing Perfetto: the attribution sweep decomposes every
    # session's wall time and the p99-vs-mean comparison names the
    # component the tail is built from (repro_torch.sim.analysis)
    from repro_torch.sim import blame_story
    report = res.analysis()
    print(blame_story(report))
    cp = report["critical_path"]
    if cp["n_hops"]:
        worst = max(cp["hops"],
                    key=lambda h: h["queue_ns"] + h["dep_wait_ns"])
        print(f"  critical path of the worst session ({cp['tenant']}): "
              f"{cp['n_hops']} hops; the longest wait sits at "
              f"#{worst['iid']} {worst['op']}@{worst['resource']} "
              f"({(worst['queue_ns'] + worst['dep_wait_ns'])/1e3:.1f} us "
              f"queued)")


if __name__ == "__main__":
    main()
