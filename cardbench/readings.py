"""The readings a cell's limits are set from, on the chip at the cell's
own sizes (run once when a cell is defined; the benchmark's own runs do
not run it):

  python3 cardbench/readings.py --workload <cell> --seeds 12 \\
      --controls 3 --first-seed <n> [--dtype float32] [--out FILE]

* lower readings: the number a run compares, ``served_gap``, of the
  program's sound runs on ``--seeds`` seeds, over the judged requests of
  enough rounds to fill the sample;
* upper readings, on the first ``--controls`` seeds: the control, the
  reference put in the program's place and computed one precision below
  the configuration's (fp8 e4m3 for bf16, TF32 for fp32): at each judged
  position, the gap of the token the control puts first;
* ``--dtype``: the program run in another working type (a witness).

Prints one JSON line per seed and writes them to ``--out``.
"""
from __future__ import annotations

import argparse
import copy
import json
import math
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:] = [p for p in sys.path
               if pathlib.Path(p or ".").resolve() != ROOT / "cardbench"]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cardbench import cells, spec, weights  # noqa: E402
from cardbench.reference.precision import Precision  # noqa: E402

CONTROL = {"bfloat16": "fp8", "float16": "fp8", "float32": "tf32"}


def serve_readings(config, traffic, seed, control, device):
    run = cells.Serving(config, traffic, seed, device)
    rounds = [run.round(r) for r in range(math.ceil(
        traffic["check_requests"] / traffic["clients"]))]
    failed = [i for rnd in rounds for i in run.failed(rnd)]
    judged = run.judged(rounds)
    run.close()
    params = weights.make(config["arch"], seed, device, config.get("init"),
                          run.layout)
    gaps, cgaps = cells.served_gaps(
        spec.reference(config), params, judged, config["arch"],
        traffic["check_batch"], device,
        Precision(CONTROL[config["arch"]["dtype"]]) if control else None)
    del params
    cells.free(device)
    out = {"failed": len(failed), "served_gap": float(gaps.max()),
           "exact_share": float((gaps == 0).mean()),
           "gap_by_position": gaps.max(axis=0).round(4).tolist()}
    if cgaps is not None:
        out.update(control_gap=float(cgaps.max()),
                   control_exact_share=float((cgaps == 0).mean()))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=7_000_000_001)
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    bench = spec.load_benchmark()
    cell = spec.find(bench["workloads"], args.workload, "workload")
    config = copy.deepcopy(spec.config_of(bench, cell))
    if args.dtype:
        config["arch"]["dtype"] = args.dtype
    traffic = spec.traffic_of(cell)
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None
    try:
        for k in range(args.seeds):
            seed = args.first_seed + k
            t0 = time.perf_counter()
            control = k < args.controls
            row = serve_readings(config, traffic, seed, control, "cuda")
            row.update(cell=cell["name"], dtype=config["arch"]["dtype"],
                       seed=seed, seconds=time.perf_counter() - t0)
            line = json.dumps(row)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
