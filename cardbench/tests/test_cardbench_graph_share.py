"""CPU tests of ``metrics/graph_share.decode.py``: the share of traced
decode steps that replayed the program's CUDA graph.

  PYTHONPATH=src python -m pytest -q cardbench/tests

The CPU never replays a graph, so a traced run there reads 0; a record
whose steps each count a replay reads 100, and one without the counter
reads nothing.
"""
import copy
import pathlib
import sys

import pytest

torch = pytest.importorskip("torch")

HERE = pathlib.Path(__file__).resolve().parents[1]
ROOT = HERE.parent
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from cardbench import run, spec  # noqa: E402

BENCH = spec.load_benchmark()
METRIC = "graph_share.decode"
CELLS = next(m["workloads"] for m in BENCH["per_layer"]
             if m["name"] == METRIC)


def small(cell_name: str):
    """The cell at CPU widths, its block kinds and working type kept."""
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


def read(rounds: int):
    return spec.reader(METRIC).read({"trace": {"rounds": rounds}})


def test_the_metric_is_declared_for_its_cells():
    declared = {m["name"]: m for m in BENCH["per_layer"]}[METRIC]
    assert declared["moves"] == "serve_tokens_per_s"
    assert declared["layer"] == "serving loop"
    assert CELLS == ["zamba2-1.2b.serve-conv",
                     "deepseek-v2-236b-ep8.serve-conv"]


@pytest.mark.parametrize("name", CELLS)
def test_an_eager_program_reads_zero(name):
    """On the CPU every decode step runs eagerly and counts no replay."""
    cell, config, traffic, limits = small(name)
    line, _ = run.result_line(BENCH, cell, config, traffic, limits,
                              2 ** 31 + 23, 0.3, True, "cpu", 0.0)
    assert line["correct"] is True
    assert line["metrics"][METRIC]["value"] == 0.0
    assert line["metrics"][METRIC]["unit"] == "%"


def test_replayed_steps_read_their_share(monkeypatch):
    from repro_torch import spans
    rec = spans.Recorder()
    monkeypatch.setattr(spans, "_profiled", rec)
    batch = rec.open("serve.batch", rids=[0, 1])
    for replays in (1, 1, 1, 0):
        step = rec.open("serve.decode_step")
        rec.add("graph.replays", replays)
        rec.close(step)
    rec.close(batch)
    assert read(1) == 75.0
    assert read(2) is None            # another number of rounds


def test_a_program_without_the_counter_reads_nothing(monkeypatch):
    from repro_torch import spans
    rec = spans.Recorder()
    monkeypatch.setattr(spans, "_profiled", rec)
    batch = rec.open("serve.batch", rids=[0])
    rec.close(rec.open("serve.decode_step"))
    rec.close(batch)
    assert read(1) is None
    monkeypatch.setattr(spans, "_profiled", None)
    assert read(1) is None
