"""Garbage collection as a background tenant: a walkthrough.

The simulator's idealized drive used to accept host writes with no
logical-to-physical mapping and no firmware background work.  Real SSDs
remap every write through a flash translation layer, and once the
over-provisioned block pool runs low a garbage collector starts copying
valid pages and erasing blocks — on the *same* dies and channels the NDP
offloader and host I/O need.  This demo makes that interference visible:

1. precondition a low-OP drive (90 % of the logical space pre-written),
2. hammer it with Zipf-skewed, write-heavy host I/O (hot LBAs hash to hot
   dies, so a few dies cross the GC watermark quickly),
3. co-run two NDP tenants, GC off vs. on, over identical streams and
   placement — every latency delta is attributable to the collector.

    PYTHONPATH=src python -m repro_torch.examples.gc_interference
"""
import argparse
import dataclasses

from repro_torch.sim import FTLConfig, HostIOStream, simulate_mix
from repro_torch.workloads import get_trace


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where the traces are made (default: the GPU; "
                         "'cpu' runs without one)")
    device = ap.parse_args().device
    workloads = ("jacobi1d", "xor_filter")
    traces = [get_trace(wl, "tiny", device=device) for wl in workloads]

    print("== write amplification vs. over-provisioning "
          "(zipf 0.95, 70% writes, 90% prefill)")
    hdr = (f"  {'op':>5s} {'WA':>6s} {'gc':>4s} {'erases':>7s} "
           f"{'max_wear':>9s} {'io_p99 off':>11s} {'io_p99 on':>10s} "
           + "".join(f"{wl + '_slow':>15s}" for wl in workloads))
    print(hdr)
    for op in (0.45, 0.28, 0.12):
        on_cfg = FTLConfig(blocks_per_die=4, pages_per_block=8,
                           op_ratio=op, prefill=0.9)
        off_cfg = dataclasses.replace(on_cfg, gc_enabled=False)
        io = HostIOStream(rate_iops=250_000, read_fraction=0.3,
                          n_requests=512, zipf_theta=0.95,
                          n_logical_pages=on_cfg.logical_pages())
        off = simulate_mix(traces, "conduit", io_stream=io, ftl=off_cfg,
                           compute_solo=False)
        on = simulate_mix(traces, "conduit", io_stream=io, ftl=on_cfg,
                          compute_solo=False)
        slows = "".join(
            f"{on.tenant(r.tenant).makespan_ns / r.makespan_ns:>14.2f}x"
            for r in off.tenants)
        print(f"  {op:5.2f} {on.ftl.write_amplification:6.2f} "
              f"{on.ftl.gc_invocations:4d} {on.ftl.blocks_erased:7d} "
              f"{on.ftl.max_erase_count:9d} "
              f"{off.host_io.p(99)/1e3:9.1f}us {on.host_io.p(99)/1e3:8.1f}us"
              f"{slows}")

    print("\n== where the wear goes (op=0.12): erase-count histogram")
    on_cfg = FTLConfig(blocks_per_die=4, pages_per_block=8,
                       op_ratio=0.12, prefill=0.9)
    io = HostIOStream(rate_iops=250_000, read_fraction=0.3, n_requests=512,
                      zipf_theta=0.95,
                      n_logical_pages=on_cfg.logical_pages())
    on = simulate_mix(traces, "conduit", io_stream=io, ftl=on_cfg,
                      compute_solo=False)
    for erases, blocks in sorted(on.ftl.wear_histogram().items()):
        bar = "#" * min(60, blocks)
        print(f"  {erases:2d} erases: {blocks:4d} blocks {bar}")
    print(f"\n  hot-LBA skew concentrates wear: "
          f"{sum(1 for c in on.ftl.erase_counts if c > 0)} of "
          f"{len(on.ftl.erase_counts)} blocks ever erased, "
          f"max wear {on.ftl.max_erase_count} erases")
    n_gc = len(on.ftl.host_during_gc_ns)
    print(f"  host requests issued while a collector was active: {n_gc} "
          f"(p99 {on.ftl.p_during_gc(99)/1e3:.1f}us vs "
          f"{on.host_io.p(99)/1e3:.1f}us overall)")


if __name__ == "__main__":
    main()
