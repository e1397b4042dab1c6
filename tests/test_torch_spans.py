"""The port's host spans and counters (``repro_torch.spans``) on the
serving path, on the CPU at tiny sizes: a Mamba2 pattern with the shared
attention block (``mamba, mamba, sattn, mamba``) and a dense one."""
import dataclasses
import time

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import configs, spans  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

# three requests in batches of two: a full batch, then a ragged one
N_REQUESTS, BATCH, PROMPT, MAX_NEW = 3, 2, 6, 4
SIZES = (2, 1)
CONFIGS = ("hybrid", "dense")


def tiny(kind: str, dtype: str = "bfloat16"):
    if kind == "hybrid":
        cfg = dataclasses.replace(
            configs.get("zamba2-1.2b").reduced(),
            block_pattern=("mamba", "mamba", "sattn", "mamba"))
    else:
        cfg = configs.get("tinyllama-1.1b").reduced()
    return dataclasses.replace(cfg, dtype=dtype)


def served(cfg, record: bool):
    gen = torch.Generator()
    gen.manual_seed(0)
    params = M.init_params(cfg, gen)
    requests = serve.make_requests(cfg, N_REQUESTS, PROMPT, MAX_NEW, seed=1)
    if not record:
        return serve.serve_requests(cfg, params, requests, BATCH, PROMPT,
                                    MAX_NEW, "cpu"), None
    with spans.recording() as rec:
        done = serve.serve_requests(cfg, params, requests, BATCH, PROMPT,
                                    MAX_NEW, "cpu")
    return done, rec


def named(record, name, **fields):
    return [s for s in record if s["name"] == name
            and all(s[k] == v for k, v in fields.items())]


def children(record, parent, name=None):
    return [s for s in record if s["parent"] == parent["id"]
            and (name is None or s["name"] == name)]


def test_off_records_nothing_and_allocates_no_span():
    assert not spans.on()
    assert spans.span("a") is spans.span("b") is spans.block("mamba", 0)
    assert spans.batch([]) is spans.span("a")
    assert spans.begin("serve.prefill") is None
    spans.end(None)
    spans.count("ssm.scan_steps", 3)
    served(tiny("hybrid"), record=False)
    assert spans._recorder is None
    with spans.recording() as rec:
        pass
    assert rec.spans() == [] and rec.counters() == []


def test_recordings_do_not_nest():
    with spans.recording():
        with pytest.raises(RuntimeError, match="already"):
            with spans.recording():
                pass
    assert not spans.on()


@pytest.mark.parametrize("kind", CONFIGS)
def test_on_and_off_serve_identical_tokens(kind):
    cfg = tiny(kind)
    off, _ = served(cfg, record=False)
    on, rec = served(cfg, record=True)
    assert [r.generated for r in on] == [r.generated for r in off]
    assert rec.spans()


@pytest.mark.parametrize("kind", CONFIGS)
def test_span_tree_of_each_batch(kind):
    cfg = tiny(kind)
    done, rec = served(cfg, record=True)
    record = rec.spans()
    by_id = {s["id"]: s for s in record}
    for s in record:        # every child inside its parent
        assert s["start_ns"] <= s["end_ns"]
        if s["parent"] >= 0:
            p = by_id[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= p["end_ns"]
            assert s["batch"] == p["batch"]
    batches = named(record, "serve.batch")
    assert [b["batch"] for b in batches] == [0, 1]
    assert [b["rids"] for b in batches] == [[0, 1], [2]]
    assert all(s["batch"] in (0, 1) for s in record)
    n_mamba = cfg.pattern.count("mamba")
    for b in batches:
        (prefill,) = children(record, b, "serve.prefill")
        steps = children(record, b, "serve.decode_step")
        assert len(steps) == MAX_NEW - 1
        for s in [prefill] + steps:
            assert len(children(record, s, "serve.sync")) == 1
        assert [c["name"] for c in children(record, prefill)] == [
            "serve.cache_init", "model.prefill", "serve.sync"]
        assert all([c["name"] for c in children(record, s)] == [
            "model.decode", "serve.sync"] for s in steps)
        blocks = [s for s in named(record, f"block.{cfg.pattern[0]}",
                                   batch=b["batch"])]
        assert len(blocks) == cfg.pattern.count(cfg.pattern[0]) * MAX_NEW
        assert {s["layer"] for s in blocks} == {
            i for i, k in enumerate(cfg.pattern) if k == cfg.pattern[0]}
        assert len(named(record, "block.mamba", batch=b["batch"])) == \
            n_mamba * (1 + len(steps))
        assert len(named(record, "model.head", batch=b["batch"])) == MAX_NEW
    if "sattn" in cfg.pattern:
        (sattn,) = [i for i, k in enumerate(cfg.pattern) if k == "sattn"]
        assert {s["layer"] for s in named(record, "block.sattn")} == {sattn}


def _counts_in(rec, span_name):
    """Counter totals by name, for each span of ``span_name`` in order."""
    record = rec.spans()
    ids = [s["id"] for s in record if s["name"] == span_name]
    out = {i: {} for i in ids}
    for c in rec.counters():
        if c["span"] in out:
            out[c["span"]][c["name"]] = c["value"]
    return [out[i] for i in ids]


@pytest.mark.parametrize("kind", CONFIGS)
def test_scan_steps_are_counted_once_a_scan(kind):
    cfg = tiny(kind)
    _, rec = served(cfg, record=True)
    n_mamba = cfg.pattern.count("mamba")
    prefills = _counts_in(rec, "serve.prefill")
    steps = _counts_in(rec, "serve.decode_step")
    assert [c.get("ssm.scan_steps", 0) for c in prefills] == \
        [n_mamba * PROMPT] * len(SIZES)
    assert [c.get("ssm.scan_steps", 0) for c in steps] == \
        [n_mamba] * len(SIZES) * (MAX_NEW - 1)
    per_batch = n_mamba * (PROMPT + MAX_NEW - 1)
    assert sum(c["value"] for c in rec.counters()
               if c["name"] == "ssm.scan_steps") == per_batch * len(SIZES)
    scans = [s for s in rec.spans() if s["name"] == "ssm.scan"]
    assert len(scans) == n_mamba * MAX_NEW * len(SIZES)


@pytest.mark.parametrize("kind", CONFIGS)
def test_cast_bytes_follow_the_cache_shape(kind):
    cfg = tiny(kind)
    _, rec = served(cfg, record=True)
    attn = sum(1 for k in cfg.pattern if k in ("attn", "sattn"))
    per_row = 2 * (PROMPT + MAX_NEW) * cfg.n_kv_heads * cfg.head_dim * 4
    want = [attn * per_row * b for b in SIZES for _ in range(MAX_NEW - 1)]
    assert [c.get("attn.cast_bytes") for c in
            _counts_in(rec, "serve.decode_step")] == want
    assert all("attn.cast_bytes" not in c
               for c in _counts_in(rec, "serve.prefill"))
    # in fp32, ``.float()`` copies nothing and nothing is counted
    _, rec32 = served(tiny(kind, "float32"), record=True)
    assert not any(c["name"] == "attn.cast_bytes" for c in rec32.counters())


def _serve_once(cfg, params):
    requests = serve.make_requests(cfg, N_REQUESTS, PROMPT, MAX_NEW, seed=1)
    done = serve.serve_requests(cfg, params, requests, BATCH, PROMPT,
                                MAX_NEW, "cpu")
    return [r.generated for r in done]


def _batches(rec):
    return [s["rids"] for s in rec.spans() if s["name"] == "serve.batch"]


def test_profiled_calls_record_by_themselves(monkeypatch):
    """Under ``torch.profiler`` each ``serve_requests`` call records into
    the profiled run's recording; an unprofiled call ends the run, and the
    next profiled call starts a new one."""
    cfg = tiny("hybrid")
    gen = torch.Generator()
    gen.manual_seed(0)
    params = M.init_params(cfg, gen)
    tokens = _serve_once(cfg, params)            # unprofiled
    before = spans.last_profiled()
    assert _serve_once(cfg, params) == tokens
    assert spans.last_profiled() is before
    with profile(activities=[ProfilerActivity.CPU]):
        assert _serve_once(cfg, params) == tokens
        assert not spans.on()
        assert _serve_once(cfg, params) == tokens
    first = spans.last_profiled()
    assert first is not before
    assert _batches(first) == [[0, 1], [2]] * 2
    assert len([s for s in first.spans()
                if s["name"] == "serve.decode_step"]) == 4 * (MAX_NEW - 1)
    with profile(activities=[ProfilerActivity.CPU]):
        _serve_once(cfg, params)                 # the same run goes on
    assert spans.last_profiled() is first and len(_batches(first)) == 6
    _serve_once(cfg, params)
    with profile(activities=[ProfilerActivity.CPU]):
        _serve_once(cfg, params)
    second = spans.last_profiled()
    assert second is not first and _batches(second) == [[0, 1], [2]]
    # a recording of its own takes the profiled call's spans
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.recording() as rec:
            _serve_once(cfg, params)
    assert spans.last_profiled() is second and len(_batches(rec)) == 2
    # held off, a profiled call records nothing and ends the run
    monkeypatch.setattr(spans, "FOLLOW_PROFILER", False)
    with profile(activities=[ProfilerActivity.CPU]):
        assert _serve_once(cfg, params) == tokens
    assert spans.last_profiled() is second and len(_batches(second)) == 2
    assert not spans.on()


def test_request_times_are_the_prefill_bounds():
    done, rec = served(tiny("hybrid"), record=True)
    record = rec.spans()
    for b in named(record, "serve.batch"):
        (prefill,) = children(record, b, "serve.prefill")
        for r in (r for r in done if r.rid in b["rids"]):
            assert r.t_start == (prefill["start_ns"] - rec.offset_ns) / 1e9
            assert r.t_first == (prefill["end_ns"] - rec.offset_ns) / 1e9


def test_requests_arrive_when_the_loop_takes_them():
    cfg = tiny("dense")
    gen = torch.Generator()
    gen.manual_seed(0)
    params = M.init_params(cfg, gen)
    requests = serve.make_requests(cfg, N_REQUESTS, PROMPT, MAX_NEW, seed=1)
    assert all(r.t_arrive is None for r in requests)
    before = time.perf_counter()
    done = serve.serve_requests(cfg, params, requests, BATCH, PROMPT,
                                MAX_NEW, "cpu")
    assert len({r.t_arrive for r in done}) == 1
    assert all(before <= r.t_arrive <= r.t_start <= r.t_first <= r.t_done
               for r in done)


def test_spans_lie_on_the_profilers_clock():
    """A span around a torch op, moved onto the profiler's clock, holds
    that op's interval within 50 µs."""
    x = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.recording() as rec:
            with spans.span("probe"):
                torch.mm(x, x)
    (probe,) = rec.spans()
    (mm,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "aten::mm"]
    start, end = mm.start_ns(), mm.start_ns() + mm.duration_ns()
    assert probe["start_ns"] - 50_000 <= start
    assert end <= probe["end_ns"] + 50_000
    assert start - probe["start_ns"] < 50_000_000   # the same clock
