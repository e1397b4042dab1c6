"""The cost of the program's span recorder (``repro_torch.spans``) when
on, in one process on the chip:

  python3 cardbench/spans_cost.py --workload <cell> --seed <n> \\
      --windows 6 --seconds 25 --traced 4 [--out FILE]

After the cell's warm rounds, ``--windows`` windows of ``--seconds``
each, the recorder off and on in turns (off, on, on, off, off, on, ...),
each giving the cell's ``serve_tokens_per_s`` and ``ttft_p95_ms`` as
``cells.serve_cell`` computes them; then ``--traced`` traced segments of
the cell's ``trace_rounds`` rounds, off and on in the same turns (off
holds the program's own recording under the profiler off too), each
giving the device's idle share as ``trace.idle_percent`` reads it.  With
the recorder on, a traced segment also gives how far each ``serve.batch``
span lies inside the profiler's range around its ``serve_requests`` call
(the two clocks' agreement), and the reduction of ``cardbench/spans.py``.
The process runs in the benchmark's environment (``run.set_environment``:
one CPU thread for the host's tensor ops).  Prints one JSON line per
window and segment.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:] = [p for p in sys.path
               if pathlib.Path(p or ".").resolve() != ROOT / "cardbench"]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from cardbench import run as harness  # noqa: E402  (imports no torch)


def turns(n: int):
    """off, on, on, off, off, on, ...: each side first as often."""
    return [(k + 1) // 2 % 2 == 1 for k in range(n)]


def recorder(on: bool):
    from repro_torch import spans
    return spans.recording() if on else contextlib.nullcontext()


def window(run, first: int, seconds: float, on: bool) -> dict:
    from cardbench.traffic import percentile
    rounds = []
    with recorder(on):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            rounds.append(run.round(first + len(rounds)))
        window_s = time.perf_counter() - t0
    reqs = [(r, rnd["handover"]) for rnd in rounds for r in rnd["requests"]]
    return {"rounds": len(rounds), "window_s": window_s,
            "serve_tokens_per_s": sum(len(r.generated) for r, _ in reqs)
            / window_s,
            "ttft_p95_ms": percentile([(r.t_first - h) * 1e3
                                       for r, h in reqs], 95)}


def clock_gaps_us(prof, rec) -> dict:
    """How far inside the profiler's ``serve_requests`` ranges the
    program's ``serve.batch`` spans start and end, in microseconds."""
    from torch.autograd import DeviceType
    calls = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CPU
                   and e.name() == "serve_requests")
    batches = sorted((s["start_ns"], s["end_ns"]) for s in rec.spans()
                     if s["name"] == "serve.batch")
    pairs = list(zip(calls, batches))
    return {"start": [(b[0] - c[0]) / 1e3 for c, b in pairs],
            "end": [(c[1] - b[1]) / 1e3 for c, b in pairs]}


def segment(run, first: int, n: int, on: bool) -> dict:
    import torch
    from torch.profiler import record_function

    from cardbench import cells, trace
    from cardbench import spans as program_record
    from repro_torch import spans
    spans.FOLLOW_PROFILER = False       # off: the profiled calls too
    try:
        with trace.traced(torch.device(run.device).type == "cuda") as prof:
            with recorder(on) as rec:
                for k in range(n):
                    with record_function("round"):
                        with record_function("serve_requests"):
                            run.round(first + k)
                        cells.sync(run.device)
    finally:
        spans.FOLLOW_PROFILER = True
    reduced = trace.reduce(prof)
    out = {"device_idle": trace.idle_percent(reduced),
           "window_s": reduced.get("window_s"),
           "busy_s": reduced.get("busy_s")}
    if on:
        program = program_record.reduce(prof, rec)
        out.update(clock_us=clock_gaps_us(prof, rec),
                   idle_by_span=program["idle_by_span"],
                   spans=program["spans"],
                   counts=program["counts"], prefill=program["prefill"],
                   decode_step=program["decode_step"],
                   idle_in_scan_ms=program["idle_in_scan_ms"],
                   program_window_ms=program["window_ms"],
                   program_busy_ms=program["busy_ms"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--windows", type=int, default=6)
    ap.add_argument("--seconds", type=float, default=25.0)
    ap.add_argument("--traced", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    harness.set_environment()       # as the benchmark runs, before torch
    import torch

    from cardbench import cells, spec
    if not torch.cuda.is_available():
        print("spans_cost: no CUDA device", file=sys.stderr)
        return 2
    bench = spec.load_benchmark()
    cell = spec.find(bench["workloads"], args.workload, "workload")
    config, traffic = spec.config_of(bench, cell), spec.traffic_of(cell)
    run = cells.Serving(config, traffic, args.seed, "cuda")
    for w in range(traffic["warm_rounds"]):
        run.round(-1 - w)
    cells.sync("cuda")
    out = open(args.out, "a") if args.out else None
    first = 0

    def emit(row: dict) -> None:
        row.update(cell=cell["name"], seed=args.seed)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    try:
        for k, on in enumerate(turns(args.windows)):
            row = window(run, first, args.seconds, on)
            first += row["rounds"]
            emit(dict(row, kind="window", k=k, recorder=on))
        for k, on in enumerate(turns(args.traced)):
            row = segment(run, first, traffic["trace_rounds"], on)
            first += traffic["trace_rounds"]
            emit(dict(row, kind="traced", k=k, recorder=on))
    finally:
        if out:
            out.close()
        run.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
