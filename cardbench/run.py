"""Run one cell of the port's benchmark once.

  python3 cardbench/run.py --workload <cell> --seed <n> --seconds <s> \\
      --trace <0|1>

from the root of a checkout.  The cell (an entry of ``BENCHMARK.json``'s
``workloads``) names its configuration and traffic mix; the run makes its
weights and inputs from the seed, warms up, measures for ``--seconds``,
and prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``: each number compared
for ``correct`` beside its limit (also the last lines of standard error).
It needs as many CUDA devices as the cell asks for; without them it
exits 2 and prints no result.  It exits 3, printing no result, if jax,
jaxlib, flax or the JAX package ``repro`` was loaded.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CACHE = ROOT / "cardbench" / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def set_environment() -> None:
    """Kernel caches at fixed paths inside the checkout; one CPU thread for
    the host's tensor ops, so the run is one process of few threads; no
    library may bring in flax."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE / "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["OMP_NUM_THREADS"] = "1"
    # the harness's modules are imported as ``cardbench.*``, never from the
    # script's own folder, where ``trace.py`` would hide the standard one
    sys.path[:] = [p for p in sys.path
                   if pathlib.Path(p or ".").resolve() != ROOT / "cardbench"]
    for path in (ROOT, ROOT / "src"):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def host_probe_ms() -> float:
    """A fixed pure-Python loop, timed: the host's speed."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(2_000_000):
        acc += i * i % 7
    return (time.perf_counter() - t0) * 1e3


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,power.draw,"
             "power.limit,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip().replace("\n", " | ") or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi not available ({err})"


def per_layer(bench: dict, cell: dict, config: dict, traffic: dict,
              result: dict) -> dict:
    from cardbench import counts, spec
    ctx = {"cell": cell, "config": config, "arch": config["arch"],
           "traffic": traffic, "counts": counts,
           "window": result["window"], "trace": result["trace"] or {}}
    out = {}
    for metric in spec.per_layer_of(bench, cell):
        value = spec.reader(metric["name"]).read(ctx)
        if value is not None:
            out[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return out


def result_line(bench: dict, cell: dict, config: dict, traffic: dict,
                limits: dict, seed: int, seconds: float, traced: bool,
                device, t_process: float) -> tuple:
    """Run the cell on ``device`` and build the result's line; returns
    (line, the cell's full result)."""
    import torch
    from cardbench import cells, spec
    result = cells.CELLS[traffic["kind"]](
        config, traffic, limits, seed, seconds, traced, device, t_process)
    if traced:
        metrics = per_layer(bench, cell, config, traffic, result)
    else:
        metrics = {m["name"]: {"value": result["e2e"][m["name"]],
                               "unit": m["unit"]}
                   for m in spec.end_to_end_of(bench, cell)}
    checks = result["checks"]
    correct = (result["failed"] == 0 and result["attempted"] > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"],
           "memory_peak_bytes": result["memory_peak_bytes"]}
    line = {"correct": correct, "attempted": result["attempted"],
            "failed": result["failed"], "metrics": metrics, "device": dev}
    if traced:
        tr = result["trace"] or {}
        dev.update(busy_s=tr.get("busy_s", 0.0),
                   window_s=tr.get("window_s", 0.0))
        line["breakdown"] = {"device_ops": tr.get("device_ops", []),
                             "idle_gaps": tr.get("idle_gaps", [])}
    line["checks"] = checks
    return line, result


def main(argv=None) -> int:
    set_environment()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from cardbench import spec
    bench = spec.load_benchmark()
    cell = spec.find(bench["workloads"], args.workload, "workload")
    config = spec.config_of(bench, cell)
    traffic = spec.traffic_of(cell)
    limits = spec.limits_of(cell)

    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        print(f"cardbench: {cell['name']} needs {cell['chips']} CUDA "
              f"device(s); torch sees {have}", file=sys.stderr)
        return 2
    from cardbench import counts
    print(f"card: {torch.cuda.get_device_name(0)} x {have}; nvidia-smi "
          f"before: {card_line()}; host probe {host_probe_ms():.1f} ms; "
          f"peaks: bf16 {counts.PEAK_FLOPS['bfloat16']:.4g} FLOP/s, fp32 "
          f"{counts.PEAK_FLOPS['float32']:.4g} FLOP/s, HBM "
          f"{counts.HBM_BYTES_PER_S:.4g} B/s (SXM data sheet, 700 W)",
          flush=True)
    line, result = result_line(bench, cell, config, traffic, limits,
                               args.seed, args.seconds, bool(args.trace),
                               "cuda", T_PROCESS)
    print(f"nvidia-smi after: {card_line()}; host probe "
          f"{host_probe_ms():.1f} ms", flush=True)
    print(f"info: {json.dumps(result['info'])}", flush=True)
    found = forbidden_modules()
    if found:
        print(f"cardbench: loaded {found}; the benchmark may load none of "
              f"{FORBIDDEN}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
