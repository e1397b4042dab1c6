"""Conduit for a GPU cluster: the six-feature cost function planning
distributed execution of DeepSeek-V2-236B on the 512-GPU production mesh.

    PYTHONPATH=src python -m repro_torch.examples.multipod_planning

The estimates are analytic (``ConduitScheduler`` with the H100's
constants); nothing runs on a device, so ``--device`` is accepted for
symmetry with the other examples and unused.
"""
import argparse

from repro_torch import configs
from repro_torch.distributed import ConduitScheduler
from repro_torch.hw.gpu_spec import H100, GPUSpec


def main(spec: GPUSpec = H100):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.parse_args()
    cfg = configs.get("deepseek-v2-236b")
    sched = ConduitScheduler(spec)
    print(f"== planning {cfg.name} train_4k on 2x16x16 (512 chips)")
    best, ests = sched.choose(cfg, "train", global_batch=256, seq_len=4096,
                              chips=512, data_par=16, model_par=16, pods=2)
    print(f"{'plan':20s} {'compute':>9s} {'memory':>9s} {'coll.':>9s} "
          f"{'exposed':>9s} {'HBM/chip':>9s} {'total':>9s} feasible")
    for e in sorted(ests, key=lambda e: e.total_s):
        mark = " <== chosen" if e.plan.name == best.plan.name else ""
        print(f"{e.plan.name:20s} {e.compute_s*1e3:8.1f}ms "
              f"{e.memory_s*1e3:8.1f}ms {e.collective_s*1e3:8.1f}ms "
              f"{e.exposed_collective_s*1e3:8.1f}ms {e.hbm_gb:8.1f}GB "
              f"{e.total_s*1e3:8.1f}ms {str(e.feasible):>5s}{mark}")


if __name__ == "__main__":
    main()
