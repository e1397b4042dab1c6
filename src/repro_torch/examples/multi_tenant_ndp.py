"""Multi-tenant NDP on one SSD: two workloads plus background host I/O.

The paper evaluates one offloaded program at a time; a shared cloud SSD
serves several tenants' NDP programs *and* ordinary read/write traffic at
once.  This demo co-runs two seed workloads under every realizable policy
on one shared fabric with a 100k-IOPS host I/O stream, and prints the
interference picture: per-tenant slowdown vs. running alone, Jain's
fairness index, and the host I/O latency distribution.

    PYTHONPATH=src python -m repro_torch.examples.multi_tenant_ndp
"""
import argparse

from repro_torch.sim import HostIOStream, jain_fairness, simulate, simulate_mix
from repro_torch.workloads import get_trace


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where the traces are made (default: the GPU; "
                         "'cpu' runs without one)")
    device = ap.parse_args().device
    workloads = ("jacobi1d", "xor_filter")
    traces = [get_trace(wl, "tiny", device=device) for wl in workloads]
    io = HostIOStream(rate_iops=100_000, n_requests=128, read_fraction=0.7)

    print(f"== tenants: {' + '.join(workloads)}  "
          f"+ host I/O {io.rate_iops:,.0f} IOPS ({io.n_requests} reqs)")
    hdr = (f"  {'policy':12s} {'makespan':>10s} "
           + "".join(f"{wl:>12s}" for wl in workloads)
           + f" {'fairness':>9s} {'io p50':>9s} {'io p99':>9s}")
    print(hdr)
    for pol in ("isp", "pud", "bw", "dm", "conduit"):
        mix = simulate_mix(traces, pol, io_stream=io)
        slow = mix.slowdowns
        cells = "".join(f"{slow[t]:>11.2f}x" for t in sorted(slow))
        print(f"  {pol:12s} {mix.makespan_ns/1e6:>8.2f}ms {cells} "
              f"{mix.fairness:>9.3f} "
              f"{mix.host_io.p(50)/1e3:>7.1f}us "
              f"{mix.host_io.p(99)/1e3:>7.1f}us")

    print("\n== interference vs. I/O intensity (conduit policy)")
    # solo baselines don't depend on the I/O level: compute them once
    solo = {f"t{i}:{wl}": simulate(tr, "conduit").makespan_ns
            for i, (wl, tr) in enumerate(zip(workloads, traces))}
    for iops in (0, 50_000, 200_000, 800_000):
        io = HostIOStream(rate_iops=iops, n_requests=128) if iops else None
        mix = simulate_mix(traces, "conduit", io_stream=io,
                           compute_solo=False)
        slow = {k: mix.tenant(k).makespan_ns / v for k, v in solo.items()}
        sl = " ".join(f"{k.split(':')[1]}={v:.2f}x"
                      for k, v in sorted(slow.items()))
        tail = (f" io_p99={mix.host_io.p(99)/1e3:.1f}us"
                if mix.host_io else "")
        print(f"  {iops:>7,d} IOPS  {sl}  "
              f"fairness={jain_fairness(list(slow.values())):.3f}{tail}")


if __name__ == "__main__":
    main()
