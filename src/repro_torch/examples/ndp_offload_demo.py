"""The paper's core study in miniature: one workload, every offloading
policy, with the decision timeline (Fig 10 style) and the six cost-function
features for a few instructions.

    PYTHONPATH=src python -m repro_torch.examples.ndp_offload_demo
"""
import argparse

from repro_torch.core import make_policy
from repro_torch.core.cost import SystemView, features_for
from repro_torch.core.isa import NDP_RESOURCES
from repro_torch.hw.ssd_spec import DEFAULT_SSD
from repro_torch.sim import simulate
from repro_torch.workloads import get_trace, sim_config_for


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where the traces are made (default: the GPU; "
                         "'cpu' runs without one)")
    device = ap.parse_args().device
    wl = "jacobi1d"
    tr = get_trace(wl, "tiny", device=device)
    cfg = sim_config_for(wl, tr)

    print(f"== {wl}: six cost-function features for the first instructions")
    view = SystemView(0.0, lambda r: 0.0, lambda i: 0.0,
                      tr.pages.location)
    for ins in tr.instrs[:4]:
        print(f"  instr {ins.iid} op={ins.op} ({ins.op_class.value})")
        feats = {r: features_for(ins, r, view, DEFAULT_SSD)
                 for r in NDP_RESOURCES}
        ok = [r for r in NDP_RESOURCES if feats[r].supported]
        best = min(ok, key=lambda r: feats[r].total) if ok else None
        for r in NDP_RESOURCES:
            f = feats[r]
            tag = ("  <- argmin" if r == best else
                   "" if f.supported else "  (unsupported)")
            print(f"    {r.value:4s} comp={f.latency_comp/1e3:9.2f}us "
                  f"dm={f.latency_dm/1e3:9.2f}us "
                  f"total={f.total/1e3:9.2f}us{tag}")

    print("\n== decision strips (first 64 instructions)")
    glyph = {"isp": "I", "pud": "D", "ifp": "F", "cpu": "c", "gpu": "g"}
    for pol in ("dm", "bw", "conduit"):
        r = simulate(tr, pol, config=cfg)
        strip = "".join(glyph[d.resource.value] for d in r.decisions[:64])
        print(f"  {pol:8s} {strip}  makespan={r.makespan_ns/1e6:.2f}ms")


if __name__ == "__main__":
    main()
