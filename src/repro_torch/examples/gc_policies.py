"""The GC policy suite: victim selection, hot/cold streams, GC suspend.

:mod:`repro_torch.examples.gc_interference` shows that garbage collection
interferes with NDP offloading and host I/O.  This walkthrough shows what
firmware *policy* does about it — the three levers `sim/ftl.py` exposes:

1. **victim selection** — who gets reclaimed.  ``greedy`` (min valid
   pages) erases whatever looks cheapest right now; ``cost_benefit``
   (the classic age-weighted ``(1-u)/2u`` score, paired with the
   cleaner's age-sorting rewrite side: still-hot survivors rejoin the
   hot append point instead of re-polluting cold compaction blocks)
   cuts write amplification; ``wear_aware`` penalizes erase counts
   above the die minimum, trading a little WA for a flat wear
   histogram (device lifetime).
2. **hot/cold separation** — two host append points keyed on per-LBA
   write counts: hot pages die together, so victims are near-empty.
3. **GC suspend/throttle** — instead of booking a whole victim cycle in
   one go (every queued host read waits behind ~all of it), the
   collector books one page copy per event, yields the die/channel pools
   between copies, and backs off while the host queue is deep.
4. And the production question: how many sessions/sec does collection
   *cost* an open-loop serving drive (``find_saturation`` with ``ftl=``)?

    PYTHONPATH=src python -m repro_torch.examples.gc_policies
"""
import argparse
import dataclasses

from repro_torch.hw.ssd_spec import FlashSpec, SSDSpec
from repro_torch.sim import (CatalogEntry, FTLConfig, HostIOStream,
                             ServingConfig, SessionCatalog,
                             drive_zipf_overwrites, find_saturation,
                             simulate_mix)
from repro_torch.workloads import get_trace

#: 4-die scaled drive: concentrates per-die churn so thousands of GC
#: cycles (where victim choice actually matters) simulate in seconds
POLICY_SSD = SSDSpec(flash=FlashSpec(channels=2, dies_per_channel=2))


def drive_zipf(cfg, n_writes=6000):
    """Precondition + Zipf-overwrite one FTL; return its stats."""
    return drive_zipf_overwrites(cfg, POLICY_SSD, n_writes)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where the traces are made (default: the GPU; "
                         "'cpu' runs without one)")
    device = ap.parse_args().device
    base = FTLConfig(blocks_per_die=32, pages_per_block=8, op_ratio=0.28,
                     prefill=0.85, gc_reserve_blocks=1)

    print("== who to reclaim: victim policy x hot/cold "
          "(zipf 0.99 churn, 6000 writes)")
    print(f"  {'victim':>13s} {'hot_cold':>8s} {'WA':>6s} "
          f"{'wear_flat':>10s} {'max_wear':>9s}")
    for vp in ("greedy", "cost_benefit", "wear_aware"):
        for hc in (False, True):
            s = drive_zipf(dataclasses.replace(base, victim_policy=vp,
                                               hot_cold=hc))
            print(f"  {vp:>13s} {str(hc):>8s} {s.write_amplification:6.2f} "
                  f"{s.wear_flatness:10.3f} {s.max_erase_count:9d}")
    print("  -> the cost-benefit cleaner (age-weighted victims + hot "
          "survivors re-joining\n     the hot stream) and the hot/cold "
          "host split each shave WA off greedy;\n     wear-aware "
          "flattens the histogram (lower max wear = longer device life)")

    print("\n== when to yield: GC suspend vs host tail latency "
          "(full 64-die drive)")
    # reserve held constant across the pair: the p99 delta is suspend-only
    geometry = FTLConfig(blocks_per_die=4, pages_per_block=8, op_ratio=0.12,
                         prefill=0.9, gc_reserve_blocks=1)
    io = HostIOStream(rate_iops=250_000, read_fraction=0.3, n_requests=512,
                      zipf_theta=0.95,
                      n_logical_pages=geometry.logical_pages())
    traces = [get_trace(wl, "tiny", device=device)
              for wl in ("jacobi1d", "xor_filter")]
    for suspend in (False, True):
        cfg = dataclasses.replace(geometry, gc_suspend=suspend)
        mix = simulate_mix(traces, "conduit", io_stream=io, ftl=cfg,
                           compute_solo=False)
        s = mix.ftl
        mode = "suspend" if suspend else "monolithic"
        print(f"  {mode:>10s}: host io p99 {mix.host_io.p(99)/1e3:9.1f}us "
              f"(during GC {s.p_during_gc(99)/1e3:9.1f}us, "
              f"{s.gc_suspensions} backoffs, WA {s.write_amplification:.2f})")
    print("  -> per-page-copy collection cuts the host tail several "
          "times over — and backing\n     off lets the host overwrite "
          "victim pages before they are copied, so WA drops too")

    print("\n== what GC costs a serving drive (p99 SLO 2 ms)")
    catalog = SessionCatalog(
        [CatalogEntry("jacobi1d",
                      get_trace("jacobi1d", "tiny", device=device),
                      weight=3.0),
         CatalogEntry("xor_filter",
                      get_trace("xor_filter", "tiny", device=device),
                      weight=1.0)],
        seed=5)
    serve_ftl = FTLConfig(blocks_per_die=4, pages_per_block=8, op_ratio=0.28,
                          prefill=0.9, gc_suspend=True, gc_reserve_blocks=1)
    serve_io = HostIOStream(rate_iops=12_000, read_fraction=0.5,
                            n_requests=128, zipf_theta=0.95,
                            n_logical_pages=serve_ftl.logical_pages())
    kw = dict(slo_p99_ns=2.0e6, rate_lo=4000, rate_hi=16_000, iters=4,
              n_sessions=48, seed=9, io_stream=serve_io,
              serving=ServingConfig(keep_session_results=False,
                                    warmup_ns=1e5, cooldown_ns=1e5))
    ideal = find_saturation(catalog, "conduit", **kw)
    collecting = find_saturation(catalog, "conduit", ftl=serve_ftl, **kw)
    print(f"  idealized drive sustains {ideal.rate_per_sec:8,.0f} sessions/s")
    print(f"  collecting drive sustains {collecting.rate_per_sec:7,.0f} "
          f"sessions/s "
          f"(GC steals {ideal.rate_per_sec - collecting.rate_per_sec:,.0f}/s)")


if __name__ == "__main__":
    main()
