"""CPU tests of the benchmark harness (``cardbench/``), at small sizes.

  PYTHONPATH=src python -m pytest -q cardbench/tests

The tests marked ``cuda`` need the card and skip elsewhere; on the card:
``PYTHONPATH=src python -m pytest -q -m cuda cardbench/tests``.
"""
import ast
import copy
import hashlib
import json
import math
import pathlib
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

HERE = pathlib.Path(__file__).resolve().parents[1]
ROOT = HERE.parent
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from cardbench import cells, counts, readings, run, spec, weights  # noqa: E402
from cardbench.reference.precision import Precision  # noqa: E402

BENCH = spec.load_benchmark()
CELLS = [c["name"] for c in BENCH["workloads"]]
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def small_arch(arch: dict) -> dict:
    """The configuration's block kinds and working type at widths a CPU
    test holds."""
    a = dict(arch, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
             vocab=512)
    if arch.get("block_pattern"):
        a.update(block_pattern=["mamba", "mamba", "sattn", "mamba"],
                 n_layers=3, ssm_state=16)
    else:
        a.update(n_layers=2)
    return a


def small(cell_name: str, **traffic_overrides):
    cell = spec.find(BENCH["workloads"], cell_name, "workload")
    config = copy.deepcopy(spec.config_of(BENCH, cell))
    config["arch"] = small_arch(config["arch"])
    traffic = dict(spec.traffic_of(cell))
    traffic.update(clients=2, prompt_len=8,
                   max_new=min(3, traffic["max_new"]), pool_rounds=2,
                   warm_rounds=1, check_requests=4, check_batch=2,
                   trace_rounds=1)
    traffic.update(traffic_overrides)
    return cell, config, traffic, spec.limits_of(cell)


def line_of(cell_name, traced=False, seconds=0.3, seed=2 ** 31 + 11,
            **overrides):
    cell, config, traffic, limits = small(cell_name, **overrides)
    line, _ = run.result_line(BENCH, cell, config, traffic, limits, seed,
                              seconds, traced, "cpu", 0.0)
    json.dumps(line)
    return cell, line


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_end_to_end_on_cpu(name):
    cell, line = line_of(name)
    assert set(line) == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True, line
    assert line["attempted"] > 0 and line["failed"] == 0
    want = {m["name"] for m in spec.end_to_end_of(BENCH, cell)}
    assert set(line["metrics"]) == want and "setup_s" in want
    assert all(math.isfinite(m["value"]) and m["value"] > 0
               for m in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_per_layer_metrics(name):
    cell, line = line_of(name, traced=True)
    assert set(line) == KEYS | {"breakdown"} and list(line)[-1] == "checks"
    assert line["correct"] is True
    allowed = {m["name"] for m in spec.per_layer_of(BENCH, cell)}
    assert line["metrics"] and set(line["metrics"]) <= allowed
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(line["breakdown"]["idle_gaps"]) <= 10
    # no device here: the device's readers find nothing and stay silent
    assert not any(n.startswith(("device_idle", "k6_", "launches"))
                   for n in line["metrics"])


def test_every_named_file_is_found():
    for entry in BENCH["configs"]:
        config = spec.read_json(ROOT / entry["file"])
        assert config["name"] == entry["name"]
        assert spec.reference(config).position_logits
        family = spec.layout(config)
        assert all(callable(getattr(family, f)) for f in (
            "layout", "prefill_flops", "k6_calls_per_prefill"))
        for key in entry["reduced"]:
            assert not key.endswith(("_dim", "_rank", "_size"))
    for cell in BENCH["workloads"]:
        assert spec.traffic_of(cell)["kind"] in cells.CELLS
        assert spec.limits_of(cell)
        assert spec.config_of(BENCH, cell)["name"] == cell["config"]
    for metric in BENCH["per_layer"]:
        assert callable(spec.reader(metric["name"]).read)
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}


def test_a_mix_and_a_metric_are_added_by_files_alone(tmp_path):
    """A new traffic mix and a new reader, in a folder of their own, are
    found by name and run without an edit to any harness file."""
    (tmp_path / "traffic").mkdir()
    (tmp_path / "metrics").mkdir()
    mix = dict(spec.traffic_of(spec.find(
        BENCH["workloads"], "stablelm-1.6b.serve-code", "workload")),
        clients=3, prompt_len=6, max_new=2, check_requests=3)
    (tmp_path / "traffic" / "tiny-mix.json").write_text(json.dumps(mix))
    (tmp_path / "metrics" / "rounds_run.py").write_text(
        "def read(ctx):\n    return float(len(ctx['window']['rounds']))\n")
    cell = {"name": "x.tiny-mix", "config": "stablelm-1.6b",
            "traffic": "tiny-mix", "chips": 1}
    traffic = spec.traffic_of(cell, here=tmp_path)
    assert traffic["clients"] == 3
    config = copy.deepcopy(spec.config_of(BENCH, cell))
    config["arch"] = small_arch(config["arch"])
    traffic.update(pool_rounds=1, warm_rounds=1, check_batch=3,
                   trace_rounds=1)
    result = cells.serve_cell(config, traffic, {"served_gap": {"limit": 1}},
                              5, 0.2, False, "cpu", 0.0)
    reader = spec.reader("rounds_run", here=tmp_path)
    assert reader.read({"window": result["window"]}) >= 1
    assert result["failed"] == 0 and result["attempted"] % 3 == 0


def test_a_configuration_is_added_by_files_alone(tmp_path, monkeypatch):
    """A configuration file that names a layout module of its own, both in
    a folder of their own, gets its weights and its model flops from that
    module through ``serve_cell``, without an edit to any harness file."""
    (tmp_path / "layouts").mkdir()
    (tmp_path / "configs").mkdir()
    (tmp_path / "layouts" / "halved-emb.py").write_text(
        "from cardbench import spec\n"
        "lm = spec.layout({}, spec.HERE)\n"
        "k6_calls_per_prefill = lm.k6_calls_per_prefill\n\n"
        "def layout(arch, init=None):\n"
        "    tree = lm.layout(arch, init)\n"
        "    tree['emb'] = (0.5, tree['emb'][1])\n"
        "    return tree\n\n"
        "def prefill_flops(arch, batch, seq):\n"
        "    return 7 * batch * seq\n")
    config = copy.deepcopy(spec.config_of(BENCH, {"config": "stablelm-1.6b"}))
    config.update(name="x", layout="halved-emb")
    config["arch"] = small_arch(config["arch"])
    (tmp_path / "configs" / "x.json").write_text(json.dumps(config))
    bench = {"configs": [{"name": "x", "file": "configs/x.json"}]}
    config = spec.config_of(bench, {"config": "x"}, root=tmp_path)
    real_layout, real_make = spec.layout, weights.make
    monkeypatch.setattr(spec, "layout",
                        lambda config, here=tmp_path: real_layout(config,
                                                                  here))
    made = []
    monkeypatch.setattr(weights, "make", lambda *a, **k: made.append(
        real_make(*a, **k)) or made[-1])
    cell, _, traffic, limits = small("stablelm-1.6b.serve-code")
    seed = 2 ** 31 + 5
    result = cells.serve_cell(config, traffic, limits, seed, 0.2, False,
                              "cpu", 0.0)
    assert result["failed"] == 0 and result["attempted"] > 0
    b, p = traffic["clients"], traffic["prompt_len"]
    assert [r["prefill_flops"] for r in result["window"]["rounds"]] == \
        [7 * b * p] * len(result["window"]["rounds"])
    mine = real_make(config["arch"], seed, "cpu", None,
                     real_layout(config, tmp_path))
    lm = real_make(config["arch"], seed, "cpu")
    assert len(made) == 2          # the program's and the reference's
    for tree in made:
        for (path, got), want, other in zip(weights.items(tree),
                                            weights.leaves(mine),
                                            weights.leaves(lm)):
            assert torch.equal(got, want), path
            assert torch.equal(got, other) == (path != "emb"), path
    assert made[0]["emb"].float().std() == pytest.approx(0.5, rel=0.05)
    chk = result["checks"]["served_gap"]
    assert chk["value"] <= chk["limit"]


def test_a_stacked_leaf_is_drawn_at_its_input_width(tmp_path):
    """A ``fan_in`` leaf ``[E, d_in, d_out]`` takes 1/sqrt(d_in), not
    1/sqrt(E), from the same flat draw in tree order."""
    (tmp_path / "layouts").mkdir()
    for name, init in (("experts", '"fan_in"'), ("experts-raw", "1.0")):
        (tmp_path / "layouts" / f"{name}.py").write_text(
            "from cardbench import spec\n"
            "lm = spec.layout({}, spec.HERE)\n"
            "prefill_flops = lm.prefill_flops\n"
            "k6_calls_per_prefill = lm.k6_calls_per_prefill\n\n"
            "def layout(arch, init=None):\n"
            "    tree = lm.layout(arch, init)\n"
            f"    tree['experts'] = ({init}, (4, 48, 96))\n"
            "    return tree\n")
    arch = dict(small_arch(spec.config_of(BENCH, {"config": "stablelm-1.6b"})
                           ["arch"]), dtype="float32")
    scaled, raw = (weights.make(arch, 3, "cpu", None,
                                spec.layout({"layout": name}, tmp_path))
                   for name in ("experts", "experts-raw"))
    assert torch.equal(scaled["experts"],
                       raw["experts"].mul(1.0 / math.sqrt(48)))
    lm = weights.make(arch, 3, "cpu")
    for (path, a), b in zip(weights.items(lm), weights.leaves(scaled)):
        assert torch.equal(a, b), path


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_the_harness_tree_is_the_programs(name):
    """The harness's parameter tree at a small size has the paths, shapes
    and types of the program's own ``init_params``, leaf by leaf."""
    from repro_torch.models.model import init_params
    config = copy.deepcopy(spec.config_of(BENCH, {"config": name}))
    config["arch"] = small_arch(config["arch"])
    ours = weights.make(config["arch"], 3, "cpu", config.get("init"),
                        spec.layout(config))
    gen = torch.Generator()
    gen.manual_seed(3)
    theirs = init_params(cells.program_config(config), gen)
    a = [(p, tuple(t.shape), t.dtype) for p, t in weights.items(ours)]
    b = [(p, tuple(t.shape), t.dtype) for p, t in weights.items(theirs)]
    first = next(((x, y) for x, y in zip(a, b) if x != y), None)
    assert first is None, f"first leaf that differs: harness {first[0]}, " \
        f"program {first[1]}"
    assert len(a) == len(b), f"harness {len(a)} leaves, program {len(b)}"


def layout_digest(tree) -> str:
    """sha256 of the JSON list of (path, init, shape) in draw order."""
    rows = [(path, leaf[0], list(leaf[1]))
            for path, leaf in weights.items(tree)]
    return hashlib.sha256(json.dumps(rows).encode()).hexdigest()


def weights_digest(tree) -> str:
    """sha256 over each leaf's path, type and values (through fp32, which
    holds a bf16 value exactly), in draw order."""
    h = hashlib.sha256()
    for path, t in weights.items(tree):
        h.update(path.encode())
        h.update(str(t.dtype).encode())
        h.update(t.float().contiguous().numpy().tobytes())
    return h.hexdigest()


# computed before the layout became the configuration's module: each
# configuration's tree at published widths, and its weights at
# ``small_arch`` from seed 1234567, with its ``init``
PINNED = {
    "zamba2-1.2b": (
        315,
        "78e239abc106b82c250790a40ed9517b18276854f3617e6b0529cae61351fff9",
        "8957ff52f64c4a8fc7e799c1f9742e8a2ef0673b7faf6501905457d534252125"),
    "stablelm-1.6b": (
        219,
        "f3f4337bab9095647261594d75358c7ed164901561f69b862e34c83a40ebaa3e",
        "c77ec91db1905872a46fd9c52e65054b1099ddbc8e81a0564658c59c7c666e81"),
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_the_layout_and_the_draw_are_as_pinned(name):
    config = spec.config_of(BENCH, {"config": name})
    arch, init, family = config["arch"], config.get("init"), \
        spec.layout(config)
    n_leaves, layout_sha, weights_sha = PINNED[name]
    tree = family.layout(arch, init)
    assert len(weights.leaves(tree)) == n_leaves
    assert layout_digest(tree) == layout_sha
    assert layout_digest(weights.layout(arch, init)) == layout_sha
    small = small_arch(arch)
    assert weights_digest(weights.make(small, 1234567, "cpu", init,
                                       family)) == weights_sha
    assert weights_digest(weights.make(small, 1234567, "cpu",
                                       init)) == weights_sha


@pytest.mark.parametrize("name", ["stablelm-1.6b.serve-code",
                                  "zamba2-1.2b.serve-conv"])
def test_reference_agrees_with_the_port_in_fp32(name):
    cell, config, traffic, limits = small(name, check_requests=6)
    config["arch"]["dtype"] = "float32"
    got = readings.serve_readings(config, traffic, 3, False, "cpu")
    assert got["served_gap"] == 0.0 and got["exact_share"] == 1.0


def test_fp8_control_reads_above_the_bf16_program():
    for name in ("stablelm-1.6b.serve-code", "zamba2-1.2b.serve-conv"):
        cell, config, traffic, limits = small(name, check_requests=8,
                                              max_new=3)
        got = readings.serve_readings(config, traffic, 4, True, "cpu")
        assert got["control_gap"] > 3 * max(got["served_gap"], 1e-3), got


def test_fp8_rounding_is_the_e4m3_grid():
    prec = Precision("fp8")
    a = torch.tensor([[1.0, 448.0, 0.3]])
    b = torch.eye(3)
    out = prec.mm(a, b)
    assert out[0, 1] == 448.0 and out[0, 0] == 1.0
    assert out[0, 2] != 0.3 and abs(out[0, 2] - 0.3) < 0.3 / 8


# -- the faults a cell can have make ``correct`` false --------------------------

@pytest.mark.parametrize("name", [n for n in CELLS if "serve" in n])
def test_a_token_altered_where_it_is_produced_is_not_correct(monkeypatch,
                                                             name):
    from repro_torch.launch import serve
    real = serve.build_prefill_step

    def altered(cfg):
        prefill = real(cfg)

        def call(params, caches, batch):
            logits, caches = prefill(params, caches, batch)
            logits = logits.clone()
            wrong = logits[0, -1].argmin()     # the least likely token
            logits[0, -1, wrong] = logits[0, -1].max() + 100.0
            return logits, caches
        return call
    monkeypatch.setattr(serve, "build_prefill_step", altered)
    _, line = line_of(name, check_requests=64)
    assert line["correct"] is False
    assert line["checks"]["served_gap"]["value"] > \
        line["checks"]["served_gap"]["limit"]


def control_serving(config: dict):
    """The control in the program's place: the plain reference with every
    product in fp8 e4m3, greedy, recomputing the whole sequence for each
    token, standing in for the program's ``serve_requests``."""
    ref, prec = spec.reference(config), Precision("fp8")

    def serve_requests(cfg, params, requests, batch, prompt_len, max_new,
                       device):
        t_start = time.perf_counter()
        toks = torch.as_tensor(np.stack([r.prompt for r in requests]),
                               dtype=torch.int64)
        for step in range(max_new):
            last = torch.tensor([toks.shape[1] - 1])
            with torch.no_grad(), prec.active():
                nxt = ref.position_logits(params, toks, last, config["arch"],
                                          prec)[:, -1].argmax(-1)
            now = time.perf_counter()
            for r, tok in zip(requests, nxt.tolist()):
                if step == 0:
                    r.t_start, r.t_first = t_start, now
                r.generated.append(tok)
            toks = torch.cat([toks, nxt[:, None]], dim=1)
        for r in requests:
            r.t_done = time.perf_counter()
        return list(requests)
    return serve_requests


# the configuration's widths at a depth a CPU test holds: there the fp8
# control reads above the cell's limit (at 4 dense layers 0.29 and 0.54 on
# seeds 12 and 13; at 7 Mamba2-and-shared blocks 1.24 and 0.89 on seeds 11
# and 12), as it does at the cell's own size on the card (PERF.md)
SHALLOW = {
    "stablelm-1.6b.serve-code": ({"n_layers": 4}, 13,
                                 {"clients": 8, "check_requests": 8,
                                  "check_batch": 8}),
    "zamba2-1.2b.serve-conv": ({"n_layers": 7, "block_pattern": [
        "mamba"] * 6 + ["sattn", "mamba"]}, 11, {}),
}


@pytest.mark.parametrize("name", CELLS)
def test_the_control_in_the_programs_place_is_not_correct(monkeypatch,
                                                          name):
    from repro_torch.launch import serve
    depth, seed, mix = SHALLOW[name]
    cell, config, traffic, limits = small(name, prompt_len=16, max_new=12,
                                          **mix)
    config["arch"] = dict(spec.config_of(BENCH, cell)["arch"], **depth)
    monkeypatch.setattr(serve, "serve_requests", control_serving(config))
    line, _ = run.result_line(BENCH, cell, config, traffic, limits, seed,
                              0.3, False, "cpu", 0.0)
    assert line["correct"] is False
    assert line["checks"]["served_gap"]["value"] > \
        line["checks"]["served_gap"]["limit"]


# -- the yardstick ---------------------------------------------------------------

def test_model_flops_at_each_cells_shapes():
    stablelm = spec.config_of(BENCH, {"config": "stablelm-1.6b"})["arch"]
    zamba = spec.config_of(BENCH, {"config": "zamba2-1.2b"})["arch"]
    # stablelm: 24 × (4·2048² + 3·2048·5632) + 2048·100352 weights a token
    w = 24 * (4 * 2048 ** 2 + 3 * 2048 * 5632) + 2048 * 100352
    assert counts.weights_per_token(stablelm) == w == 1_438_646_272
    attn_1500 = 24 * 2 * (24 * 32) * 64 * 1500 * 1501
    assert counts.prefill_flops(stablelm, 24, 1500) == \
        2 * w * 24 * 1500 + attn_1500
    # zamba2: 38 Mamba2 blocks, 6 shared-block applications, tied head
    mamba = 2048 * 8192 + 2048 * 128 + 2048 * 4096 + 4096 * 2048
    shared = 4 * 2048 ** 2 + 3 * 2048 * 8192
    wz = 38 * mamba + 6 * shared + 2048 * 32000
    assert counts.weights_per_token(zamba) == wz == 1_753_219_072
    scan = 38 * 5 * 4096 * 64
    assert counts.prefill_flops(zamba, 32, 1020) == \
        (2 * wz + scan) * 32 * 1020 + 6 * 2 * (32 * 32) * 64 * 1020 * 1021


def test_k6_work_at_each_cells_shapes():
    stablelm = spec.config_of(BENCH, {"config": "stablelm-1.6b"})["arch"]
    zamba = spec.config_of(BENCH, {"config": "zamba2-1.2b"})["arch"]
    code = counts.k6_call(stablelm, 24, 1500)
    assert code["flops"] == 2 * 768 * 64 * 1500 * 1501
    assert code["bytes"] == 4 * 768 * 1500 * 64 * 2
    assert code["by"] == "flops"
    assert code["bound_s"] == pytest.approx(code["flops"] / 989e12)
    assert code["bound_s"] == pytest.approx(0.000224, rel=0.01)
    conv = counts.k6_call(zamba, 32, 1020)
    assert conv["bytes"] == 4 * 1024 * 1020 * 64 * 2 and conv["by"] == "bytes"
    assert conv["bound_s"] == pytest.approx(conv["bytes"] / 3.35e12)
    assert counts.k6_calls_per_prefill(stablelm) == 24
    assert counts.k6_calls_per_prefill(zamba) == 6


def test_percentile_is_nearest_rank():
    from cardbench.traffic import percentile
    values = list(range(1, 101))
    assert percentile(values, 95) == 95 and percentile(values, 100) == 100
    assert percentile([3.0], 95) == 3.0


def test_weights_come_from_the_seed():
    arch = small_arch(spec.config_of(BENCH, {"config": "zamba2-1.2b"})[
        "arch"])
    one, two = weights.make(arch, 9, "cpu"), weights.make(arch, 9, "cpu")
    other = weights.make(arch, 10, "cpu")
    for a, b, c in zip(weights.leaves(one), weights.leaves(two),
                       weights.leaves(other)):
        assert torch.equal(a, b)
    assert not torch.equal(one["emb"], other["emb"])
    assert one["layers"][0]["a_log"].dtype == torch.float32
    assert one["layers"][2] == {} and "shared_attn" in one



def test_init_factors_come_from_the_configuration():
    config = spec.config_of(BENCH, {"config": "zamba2-1.2b"})
    assert config["init"] == {"mamba.w_bc": 0.25}
    assert any("`init`" in d for d in config["departures"])
    arch = small_arch(config["arch"])
    plain = weights.make(arch, 9, "cpu")
    scaled = weights.make(arch, 9, "cpu", config["init"])
    for i, kind in enumerate(arch["block_pattern"]):
        for leaf, p in plain["layers"][i].items():
            q = scaled["layers"][i][leaf]
            factor = 0.25 if (kind, leaf) == ("mamba", "w_bc") else 1.0
            assert torch.equal(q, p * factor)

# -- what the harness and the reference may import ------------------------------

def _top_level_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_no_file_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        found = set(_top_level_imports(path)) & {"jax", "jaxlib", "flax",
                                                  "repro"}
        assert not found, f"{path} imports {found}"


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        assert "repro_torch" not in set(_top_level_imports(path)), path


def test_a_run_that_loaded_jax_prints_no_result(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", object())
    assert run.forbidden_modules() == ["jax"]
    monkeypatch.delitem(sys.modules, "jax")
    monkeypatch.setitem(sys.modules, "repro_torch_x", object())
    assert run.forbidden_modules() == []


def test_without_a_card_the_command_exits_without_a_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                     "1"]) == 2
    assert capsys.readouterr().out == ""


# -- on the card ----------------------------------------------------------------
