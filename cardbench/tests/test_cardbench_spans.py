"""CPU tests of the readers of the program's own spans and counters
(``cardbench/spans.py`` and its metrics), at small sizes.

  PYTHONPATH=src python -m pytest -q cardbench/tests
"""
import copy
import json
import math
import pathlib
import sys
from collections import defaultdict

import numpy as np
import pytest

torch = pytest.importorskip("torch")

HERE = pathlib.Path(__file__).resolve().parents[1]
ROOT = HERE.parent
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from torch.profiler import record_function  # noqa: E402

from cardbench import cells, run, spec, trace  # noqa: E402
from cardbench import spans as program_record  # noqa: E402

BENCH = spec.load_benchmark()
CELLS = [c["name"] for c in BENCH["workloads"]]

# the program's own spans and counters: readers that need no device
PROGRAM_READERS = {
    "zamba2-1.2b.serve-conv": {"scan_steps.prefill", "scan_ms.prefill",
                               "decode_host_ms", "cast_mb_per_step.decode"},
    "stablelm-1.6b.serve-code": {"prefill_host_ms"},
}


def small(cell_name: str):
    """The cell at the sizes of ``test_cardbench_harness.py``: the
    configuration's block kinds and working type, CPU widths."""
    cell = spec.find(BENCH["workloads"], cell_name, "workload")
    config = copy.deepcopy(spec.config_of(BENCH, cell))
    arch = dict(config["arch"], d_model=64, n_heads=4, n_kv_heads=4,
                d_ff=128, vocab=512)
    if arch.get("block_pattern"):
        arch.update(block_pattern=["mamba", "mamba", "sattn", "mamba"],
                    n_layers=3, ssm_state=16)
    else:
        arch.update(n_layers=2)
    config["arch"] = arch
    traffic = dict(spec.traffic_of(cell))
    traffic.update(clients=2, prompt_len=8,
                   max_new=min(3, traffic["max_new"]), pool_rounds=2,
                   warm_rounds=1, check_requests=4, check_batch=2,
                   trace_rounds=1)
    return cell, config, traffic, spec.limits_of(cell)


def test_every_reader_of_the_program_is_declared():
    declared = {m["name"]: m for m in BENCH["per_layer"]}
    for cell, names in PROGRAM_READERS.items():
        for name in names:
            assert declared[name]["workloads"] == [cell]
            assert (HERE / "metrics" / f"{name}.py").is_file()


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_the_programs_spans(name):
    cell, config, traffic, limits = small(name)
    line, result = run.result_line(BENCH, cell, config, traffic, limits,
                                   2 ** 31 + 11, 0.3, True, "cpu", 0.0)
    assert line["correct"] is True
    metrics = {k: m["value"] for k, m in line["metrics"].items()}
    assert PROGRAM_READERS[name] <= set(metrics)
    assert all(math.isfinite(metrics[k]) and metrics[k] > 0
               for k in PROGRAM_READERS[name])
    if name.startswith("zamba2"):
        # 3 Mamba2 layers x 8 prompt tokens; 1 shared block's k and v,
        # 2 requests x 11 positions x 4 heads x 16 dims in fp32
        assert metrics["scan_steps.prefill"] == 24
        assert metrics["cast_mb_per_step.decode"] == pytest.approx(
            2 * 2 * 11 * 4 * 16 * 4 / 1e6) == 0.011264
    # the harness's own keys are as they were
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(result["info"])


def test_the_measured_window_records_nothing():
    """The program records only while the profiler is on: a ``--trace 0``
    run leaves the latest profiled record as it was."""
    from repro_torch import spans
    cell, config, traffic, limits = small("zamba2-1.2b.serve-conv")
    before = spans.last_profiled()
    line, _ = run.result_line(BENCH, cell, config, traffic, limits, 5,
                              0.3, False, "cpu", 0.0)
    assert line["correct"] is True
    assert spans.last_profiled() is before and not spans.on()


def test_a_program_without_spans_reads_nothing_and_raises_nothing(
        monkeypatch):
    """The readers of the program's spans stay silent on a program that
    records none (an import of ``repro_torch.spans`` fails)."""
    from repro_torch.launch import serve  # noqa: F401  (loaded before)
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    cell, config, traffic, limits = small("zamba2-1.2b.serve-conv")
    line, _ = run.result_line(BENCH, cell, config, traffic, limits, 7,
                              0.3, True, "cpu", 0.0)
    assert line["correct"] is True and line["metrics"]
    assert not set(line["metrics"]) & set.union(*PROGRAM_READERS.values())


def test_a_record_of_other_rounds_is_not_read(monkeypatch):
    """A profiled record whose batches are not the traced rounds' (one a
    round) gives nothing; one that is, gives its summary."""
    from repro_torch import spans
    cell, config, traffic, _ = small("stablelm-1.6b.serve-code")
    served = cells.Serving(config, traffic, 3, "cpu")
    served.round(0)               # unprofiled: the next profiled run is new
    with trace.traced(False):
        served.round(1)
        served.round(2)
    served.close()
    assert program_record.program({"trace": {"rounds": 2}})["batches"] == 2
    assert program_record.program({"trace": {"rounds": 1}}) is None
    assert program_record.program({"trace": {}}) is None
    monkeypatch.setattr(spans, "_profiled", None)
    assert program_record.program({"trace": {"rounds": 2}}) is None


def test_idle_by_span_sums_to_the_window_less_the_busy_union():
    """``reduce`` over a CPU trace of two rounds: every idle nanosecond is
    under a span or under ``(no program span)``."""
    from repro_torch import spans
    cell, config, traffic, _ = small("zamba2-1.2b.serve-conv")
    served = cells.Serving(config, traffic, 3, "cpu")
    with trace.traced(False) as prof:
        with spans.recording() as rec:
            for k in range(2):
                with record_function("round"):
                    served.round(k)
    served.close()
    out = program_record.reduce(prof, rec)
    rows = out["idle_by_span"]
    assert rows[-1][0] == program_record.NO_SPAN and len(rows) <= 12
    assert out["busy_ms"] == 0.0 and out["idle_in_scan_ms"] > 0
    assert sum(ms for _, ms in rows) == pytest.approx(
        out["window_ms"] - out["busy_ms"], abs=1e-6)
    assert out["batches"] == 2 and out["prefill"]["n"] == 2
    json.dumps(out)


def test_idle_split_over_innermost_spans_is_exact():
    """Each idle nanosecond goes to the innermost span open at it: the
    split against a count nanosecond by nanosecond."""
    rng = np.random.default_rng(3)
    record, t = [], 0
    for top in range(4):                      # a tree two levels deep
        start = t
        kids = []
        t += int(rng.integers(0, 5))
        for k in range(3):
            a = t + int(rng.integers(0, 4))
            b = a + int(rng.integers(1, 9))
            kids.append({"name": f"k{k % 2}", "id": 10 * top + k + 1,
                         "parent": 10 * top, "start_ns": a, "end_ns": b})
            t = b
        t += int(rng.integers(0, 5))
        record.append({"name": "top", "id": 10 * top, "parent": -1,
                       "start_ns": start, "end_ns": t})
        record.extend(kids)
        t += int(rng.integers(0, 6))
    busy = np.zeros(t + 5, bool)
    for _ in range(12):
        a = int(rng.integers(0, t))
        busy[a:a + int(rng.integers(1, 6))] = True
    edges = np.flatnonzero(np.diff(np.r_[0, ~busy, 0]))
    gap_s, gap_e = edges[::2], edges[1::2]
    kids = defaultdict(list)
    for s in record:
        kids[s["parent"]].append(s)
    seg_s, seg_e, names = program_record._innermost(record, kids)
    at = program_record._idle_before(gap_s, gap_e)
    got = defaultdict(int)
    for n, v in zip(names, at(seg_e) - at(seg_s)):
        got[n] += int(v)
    want = defaultdict(int)
    for ns in np.flatnonzero(~busy):
        open_ = [s for s in record if s["start_ns"] <= ns < s["end_ns"]]
        if open_:
            inner = max(open_, key=lambda s: s["parent"] >= 0)
            want[inner["name"]] += 1
    assert {k: v for k, v in got.items() if v} == dict(want)
    assert int(at([t + 5])[0]) == int((~busy).sum())
