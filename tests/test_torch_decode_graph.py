"""The serving decode step as a CUDA graph (``repro_torch.launch.graphs``)
and what it needs of the model: a decode step whose position is a 0-d
device tensor, never read on the host, and Mamba2 states that land on
the given buffers.

On the CPU: a tensor index steps exactly as an int; a decode step reads
no tensor index on the host (GQA, Mamba2, and MLA with a held share of a
group-limited MoE, ``test_torch_deepseek_share.py``'s DeepSeek-V2 kinds);
Mamba2's prefill and decode steps write their states over the given ones;
the engagement rule over ``configs.ARCHS`` and the held-expert MLA
config; the eager step counts no replay; a graph's eager steps, the
batches it hands its buffers to (of the graph's cache length alone), and
its end with the parameters.  The ``cuda`` tests need the card:

  PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
      tests/test_torch_decode_graph.py
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs, spans  # noqa: E402
from repro_torch.launch import graphs, serve  # noqa: E402
from repro_torch.launch.steps import build_serve_step  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models.config import ArchConfig  # noqa: E402
from test_torch_deepseek_share import ARCH as DS_ARCH  # noqa: E402

PROMPT, STEPS = 6, 5
# the configs whose decode step replays a graph on the card, by their
# block kinds: attn, sattn and mamba only (no catalog config routes over
# held experts: dbrx-132b and deepseek-v2-236b take the capacity MoE)
ENGAGE = {"minicpm-2b", "tinyllama-1.1b", "qwen3-4b", "stablelm-1.6b",
          "zamba2-1.2b", "qwen2-vl-2b"}
# DeepSeek-V2's kinds at CPU widths (MLA with YaRN, a dense layer, then
# group-limited MoE layers), holding 8 of the 32 routed experts from the
# 8th on, as one device of an expert-parallel layer does
HELD_MLA = "ds-held"


def reduced(arch: str, dtype: str = "bfloat16"):
    if arch == HELD_MLA:
        return ArchConfig(**dict(DS_ARCH, n_experts=8, expert_offset=8,
                                 dtype=dtype))
    cfg = configs.get(arch).reduced()
    if arch == "zamba2-1.2b":      # the shared attention block runs
        cfg = dataclasses.replace(
            cfg, block_pattern=("mamba", "mamba", "sattn", "mamba"))
    return dataclasses.replace(cfg, dtype=dtype)


def model(cfg, device="cpu", seed=0):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return M.init_params(cfg, gen)


def prefilled(cfg, params, batch=2, device="cpu", seed=3, steps=STEPS):
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (batch, PROMPT), generator=gen)
    caches = M.init_cache(cfg, batch, PROMPT + steps, device)
    logits, caches = M.prefill(cfg, params, tokens.to(device), caches)
    return torch.argmax(logits[:, -1], dim=-1), caches


def clone(caches):
    return [{k: t.clone() for k, t in c.items()} for c in caches]


class NoHostRead(torch.Tensor):
    """A tensor, and every tensor computed from it, that raises where its
    values would be read on the host."""

    def _read(self, *args, **kwargs):
        raise AssertionError("a value computed from the index was read on "
                             "the host")

    item = tolist = _read
    __bool__ = __int__ = __index__ = __float__ = _read


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "stablelm-1.6b", HELD_MLA])
def test_a_tensor_index_steps_as_an_int(arch):
    """Logits, caches and states equal bit for bit, step after step."""
    cfg = reduced(arch)
    params = model(cfg)
    with torch.no_grad():
        nxt, caches = prefilled(cfg, params)
        a, b = clone(caches), clone(caches)
        tok_a = tok_b = nxt
        for step in range(STEPS - 1):
            index = PROMPT + step
            la, a = M.decode_step(cfg, params, tok_a, index, a)
            lb, b = M.decode_step(cfg, params, tok_b,
                                  torch.tensor(index, dtype=torch.int64), b)
            assert torch.equal(la, lb)
            for ca, cb in zip(a, b):
                assert ca.keys() == cb.keys()
                assert all(torch.equal(ca[k], cb[k]) for k in ca)
            tok_a, tok_b = torch.argmax(la, -1), torch.argmax(lb, -1)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "stablelm-1.6b", HELD_MLA])
def test_a_decode_step_never_reads_the_index_on_the_host(arch):
    cfg = reduced(arch)
    params = model(cfg)
    with torch.no_grad():
        nxt, caches = prefilled(cfg, params)
        want, _ = M.decode_step(cfg, params, nxt, PROMPT, clone(caches))
        index = torch.tensor(PROMPT).as_subclass(NoHostRead)
        with pytest.raises(AssertionError):
            bool(index == PROMPT)
        got, _ = M.decode_step(cfg, params, nxt, index, caches)
    assert torch.equal(got.as_subclass(torch.Tensor), want)


def test_the_prefill_branch_is_chosen_before_the_index_is_read(
        monkeypatch):
    """A one-token call takes the cached product without looking at the
    index; a prompt at index 0 takes the kernel's path."""
    cfg = reduced("stablelm-1.6b", "float32")
    p = model(cfg)["layers"][0]["attn"]
    whole = []
    sdpa = L._sdpa_on_shards

    def spy(*args):
        whole.append(args[0].shape[1])
        return sdpa(*args)

    monkeypatch.setattr(L, "_sdpa_on_shards", spy)
    cache = M.init_cache(cfg, 2, PROMPT + 1, "cpu")[0]
    x = torch.randn(2, PROMPT, cfg.d_model)
    L.gqa_attention(p, cfg, x, torch.arange(PROMPT).expand(2, PROMPT),
                    dict(cache, index=0))
    assert whole == [PROMPT]
    index = torch.tensor(PROMPT).as_subclass(NoHostRead)
    _, new = L.gqa_attention(p, cfg, x[:, :1],
                             torch.full((2, 1), PROMPT),
                             dict(cache, index=index))
    assert whole == [PROMPT]
    assert new["k"] is cache["k"]
    assert bool((cache["k"][:, PROMPT] != 0).any())


def test_a_mamba_decode_step_writes_its_state_in_place():
    cfg = reduced("zamba2-1.2b")
    params = model(cfg)
    with torch.no_grad():
        nxt, caches = prefilled(cfg, params)
        before = clone(caches)
        _, after = M.decode_step(cfg, params, nxt, PROMPT, caches)
    for i, kind in enumerate(cfg.pattern):
        if kind == "mamba":
            assert after[i]["h"] is caches[i]["h"]
            assert after[i]["conv"] is caches[i]["conv"]
            assert not torch.equal(after[i]["h"], before[i]["h"])


def test_a_mamba_prefill_writes_its_state_in_place():
    """Prefill fills the caches it is given, states too, so a batch keeps
    its buffers from prefill on; the numbers are those of fresh
    states."""
    cfg = reduced("zamba2-1.2b")
    params = model(cfg)
    tokens = torch.randint(0, cfg.vocab, (2, PROMPT),
                           generator=torch.Generator().manual_seed(5))
    given = M.init_cache(cfg, 2, PROMPT + 1, "cpu")
    mine = [dict(c) for c in given]
    with torch.no_grad():
        logits, out = M.prefill(cfg, params, tokens, mine)
        with S.scan_steps(PROMPT):         # the loop: fresh states
            want_logits, want = M.prefill(
                cfg, params, tokens, M.init_cache(cfg, 2, PROMPT + 1, "cpu"))
    assert torch.equal(logits, want_logits)
    for c, new, ref in zip(given, out, want):
        assert all(new[k] is c[k] for k in c)
        assert all(torch.equal(new[k], ref[k]) for k in c)
    assert bool(given[0]["h"].abs().sum() > 0)


@pytest.mark.parametrize("arch", configs.ARCHS + configs.PAPER_ARCHS)
def test_engagement_follows_the_block_kinds(arch):
    cfg = configs.get(arch)
    kinds_only = set(cfg.pattern) <= set(M.CAPTURABLE_KINDS)
    assert kinds_only == (arch in ENGAGE | {"llama2-7b"})
    assert graphs.engages(cfg, "cuda") == kinds_only
    assert graphs.engages(cfg.reduced(), torch.device("cuda", 0)) == \
        kinds_only
    assert not graphs.engages(cfg, "cpu")
    L.set_mesh_axes(("data",), "model")
    try:
        assert not graphs.engages(cfg, "cuda")
    finally:
        L.set_mesh_axes((), None)
    with S.scan_steps(8):          # Mamba2 through its loop
        assert not graphs.engages(cfg, "cuda")


def test_a_held_expert_mla_config_engages_and_a_capacity_moe_does_not():
    """MLA, and ``moe`` blocks that route over held experts in bf16 (no
    capacity, grouped GEMMs over device offsets), are admitted; the same
    config in fp32 (where torch's grouped GEMM copies its offsets to the
    host), or with the capacity MoE, and the catalog's dbrx-132b and
    deepseek-v2-236b (capacity MoE), step eagerly, as does any config
    under a mesh."""
    cfg = reduced(HELD_MLA)
    assert cfg.mla and cfg.held_experts and "moe" in cfg.pattern
    assert M.decode_capturable(cfg)
    assert graphs.engages(cfg, "cuda") and not graphs.engages(cfg, "cpu")
    assert not graphs.engages(reduced(HELD_MLA, "float32"), "cuda")
    capacity = dataclasses.replace(cfg, n_experts=32, router_experts=0,
                                   expert_offset=0)
    assert not capacity.held_experts
    assert not graphs.engages(capacity, "cuda")
    for arch in ("dbrx-132b", "deepseek-v2-236b"):
        for c in (configs.get(arch), configs.get(arch).reduced()):
            assert "moe" in c.pattern and not c.held_experts
            assert not graphs.engages(c, "cuda")
    L.set_mesh_axes(("data",), "model")
    try:
        assert not graphs.engages(cfg, "cuda")
    finally:
        L.set_mesh_axes((), None)


def test_an_eager_step_counts_no_replay():
    cfg = reduced("zamba2-1.2b")
    params = model(cfg)
    requests = serve.make_requests(cfg, 2, PROMPT, 4, seed=1)
    with spans.recording() as rec:
        serve.serve_requests(cfg, params, requests, 2, PROMPT, 4, "cpu")
    steps = {s["id"] for s in rec.spans()
             if s["name"] == "serve.decode_step"}
    counted = [c for c in rec.counters() if c["name"].startswith("graph.")]
    assert len(steps) == 3
    assert sorted((c["span"], c["name"], c["value"]) for c in counted) == \
        sorted((sid, "graph.replays", 0) for sid in steps)
    assert graphs._HELD[0] is None


def test_a_graph_runs_its_first_steps_eagerly_on_the_given_caches(
        monkeypatch):
    """Before its capture a graph steps eagerly, bit for bit as the plain
    step, on the caches it was made on, and counts no replay."""
    cfg = reduced("zamba2-1.2b", "float32")
    params = model(cfg)
    monkeypatch.setattr(graphs, "engages", lambda cfg, device: True)
    graphs._release()
    try:
        with torch.no_grad():
            nxt, caches = prefilled(cfg, params)
            plain, out = clone(caches), caches
            tok_g = tok_p = nxt
            with spans.recording() as rec:
                for step in range(graphs.WARMUP_STEPS):
                    with spans.span("serve.decode_step"):
                        lg, out = graphs.decode(cfg, params, out, tok_g,
                                                PROMPT + step)
                    graph = graphs._HELD[0]
                    lp, plain = M.decode_step(cfg, params, tok_p,
                                              PROMPT + step, plain)
                    assert torch.equal(lg, lp)
                    assert graph.serves(cfg, params, out)
                    assert graph.serves(cfg, params, caches)
                    for c, ref in zip(out, plain):
                        assert all(torch.equal(c[k], ref[k]) for k in c)
                    tok_g, tok_p = torch.argmax(lg, -1), torch.argmax(lp, -1)
    finally:
        graphs._release()
    assert graph.graph is None and graph.eager_steps == graphs.WARMUP_STEPS
    assert [c["value"] for c in rec.counters()
            if c["name"].startswith("graph.")] == \
        [0] * graphs.WARMUP_STEPS
    assert not graph.serves(cfg, params, clone(caches))
    assert not graph.serves(cfg, model(cfg), caches)


@pytest.mark.parametrize("arch, key", [("stablelm-1.6b", "k"),
                                       (HELD_MLA, "latent")])
def test_a_batch_that_fits_the_held_graph_gets_its_buffers_zeroed(
        arch, key, monkeypatch):
    """Of the graph's batch size, cache length (KV or MLA latent) and
    parameters alone."""
    cfg = reduced(arch, "float32")
    params = model(cfg)
    with torch.no_grad():
        nxt, caches = prefilled(cfg, params)
    graphs._release()
    graph = graphs._HELD[0] = graphs.DecodeGraph(cfg, params, caches, nxt)
    try:
        # on the CPU no graph engages: every batch gets fresh caches
        fresh = graphs.init_cache(cfg, params, 2, PROMPT + STEPS, "cpu")
        assert not any(f[key] is c[key] for f, c in zip(fresh, caches))
        monkeypatch.setattr(graphs, "engages", lambda cfg, device: True)
        got = graphs.init_cache(cfg, params, 2, PROMPT + STEPS, "cpu")
        assert graph.serves(cfg, params, got)
        assert all(not t.any() for c in got for t in c.values())
        want = M.init_cache(cfg, 2, PROMPT + STEPS, "cpu")
        assert [{k: (t.shape, t.dtype) for k, t in c.items()}
                for c in got] == [{k: (t.shape, t.dtype)
                                   for k, t in c.items()} for c in want]
        for batch, seq, other in ((3, PROMPT + STEPS, params),
                                  (2, PROMPT + STEPS + 1, params),
                                  (2, PROMPT + STEPS, model(cfg))):
            mine = graphs.init_cache(cfg, other, batch, seq, "cpu")
            assert not any(m[key] is c[key] for m, c in zip(mine, caches))
        # the graph goes with its parameters
        del params
        assert graphs._HELD[0] is None
    finally:
        graphs._release()


def _eager(monkeypatch):
    monkeypatch.setattr(graphs, "engages", lambda cfg, device: False)


def _steps(cfg, params, nxt, caches, n):
    """Logits of ``n`` decode steps through the step function."""
    fn = build_serve_step(cfg)
    out = []
    for step in range(n):
        logits, caches = fn(params, caches, nxt, PROMPT + step)
        nxt = torch.argmax(logits, dim=-1)
        out.append(logits)
    return out


def _served(cfg, params, seed):
    """Tokens, summed counters and the scan kernel's runs on the device
    (a device trace, which sees a replayed graph's kernels) of a
    ``serve_requests`` call: 2 batches of a prefill and STEPS - 1
    steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    requests = serve.make_requests(cfg, 4, PROMPT, STEPS, seed=seed)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with spans.recording() as rec:
            done = serve.serve_requests(cfg, params, requests, 2, PROMPT,
                                        STEPS, "cuda")
        torch.cuda.synchronize()
    counts = {}
    for c in rec.counters():
        counts[c["name"]] = counts.get(c["name"], 0) + c["value"]
    runs = sum(1 for e in prof.profiler.kineto_results.events()
               if e.device_type() != DeviceType.CPU
               and "selective_scan_kernel" in e.name())
    return [r.generated for r in done], counts, runs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graphed_serving_is_eager_serving(dtype, monkeypatch):
    """On the card: a replayed step gives the eager step's logits and
    tokens, bit for bit, counts what the eager step counts and runs the
    scan kernel as often (a device trace), and two ``serve_requests``
    calls of one shape capture once, on one set of buffers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    from repro_torch.kernels import _build, ops
    if _build.find_nvcc() is None:
        pytest.skip("needs nvcc to build csrc/scan.cu: not found")
    cfg = reduced("zamba2-1.2b", dtype)
    params = model(cfg, "cuda")
    n = graphs.WARMUP_STEPS + 4
    graphs._release()
    with torch.no_grad():
        nxt, caches = prefilled(cfg, params, device="cuda", steps=n + 1)
        graphed = _steps(cfg, params, nxt, clone(caches), n)
        assert graphs._HELD[0].graph is not None
        with monkeypatch.context() as m:
            _eager(m)
            eager = _steps(cfg, params, nxt, clone(caches), n)
    for g, e in zip(graphed, eager):
        assert torch.equal(g, e)

    graphs._release()
    blocks, batches = cfg.pattern.count("mamba"), 2
    ops.reset_launch_counts()
    tokens, counts, runs = _served(cfg, params, seed=1)
    held = graphs._HELD[0]
    again, counts2, runs2 = _served(cfg, params, seed=1)
    assert graphs._HELD[0] is held
    # the wrappers launched the prefills, the eager steps and the capture
    assert ops.launch_counts()["selective_scan"] == blocks * (
        2 * batches + graphs.WARMUP_STEPS + 1)
    with monkeypatch.context() as m:
        _eager(m)
        want, eager_counts, eager_runs = _served(cfg, params, seed=1)
    assert tokens == again == want
    steps = batches * (STEPS - 1)
    assert runs == runs2 == eager_runs == blocks * batches * STEPS
    assert counts.pop("graph.captures") == 1
    assert "graph.captures" not in counts2
    assert counts.pop("graph.replays") == steps - graphs.WARMUP_STEPS
    assert counts2.pop("graph.replays") == steps
    assert eager_counts.pop("graph.replays") == 0
    assert counts == counts2 == eager_counts
    assert eager_counts["ssm.scan_steps"] == \
        blocks * batches * (PROMPT + STEPS - 1)
    # the graph goes with the parameters
    del params
    assert graphs._HELD[0] is None


@pytest.mark.cuda
def test_graphed_serving_is_eager_serving_with_mla_and_held_experts(
        monkeypatch):
    """On the card, at the held-expert MLA arch in bf16 with DeepSeek-V2's
    head widths (so that the prompt goes through K6 at 192/128, as in the
    serving cell): a replayed step gives the eager step's logits and
    tokens, bit for bit, counts what the eager step counts (the whole
    latent cache a step in ``mla.cache_bytes``), and two
    ``serve_requests`` calls of one shape capture once, on one set of
    buffers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    from repro_torch.kernels import _build
    if _build.find_nvcc() is None:
        pytest.skip("needs nvcc to build csrc/attention.cu: not found")
    cfg = dataclasses.replace(reduced(HELD_MLA), d_head=128,
                              rope_head_dim=64)
    params = model(cfg, "cuda")
    n = graphs.WARMUP_STEPS + 4
    graphs._release()
    with torch.no_grad():
        nxt, caches = prefilled(cfg, params, device="cuda", steps=n + 1)
        graphed = _steps(cfg, params, nxt, clone(caches), n)
        assert graphs._HELD[0].graph is not None
        with monkeypatch.context() as m:
            _eager(m)
            eager = _steps(cfg, params, nxt, clone(caches), n)
    for g, e in zip(graphed, eager):
        assert torch.equal(g, e)

    graphs._release()
    tokens, counts, _ = _served(cfg, params, seed=1)
    held = graphs._HELD[0]
    again, counts2, _ = _served(cfg, params, seed=1)
    assert graphs._HELD[0] is held
    with monkeypatch.context() as m:
        _eager(m)
        want, eager_counts, _ = _served(cfg, params, seed=1)
    assert tokens == again == want
    batches, b, steps = 2, 2, STEPS - 1
    assert counts.pop("graph.captures") == 1
    assert "graph.captures" not in counts2
    assert counts.pop("graph.replays") == batches * steps \
        - graphs.WARMUP_STEPS
    assert counts2.pop("graph.replays") == batches * steps
    assert eager_counts.pop("graph.replays") == 0
    assert counts == counts2 == eager_counts
    # a prefill: the prompt's keys and values (K6); a step: the whole cache
    r, rd, dh, h = cfg.kv_lora_rank, cfg.rope_head_dim, cfg.head_dim, \
        cfg.n_heads
    item, layers = 2, len(cfg.pattern)
    assert eager_counts["mla.cache_bytes"] == layers * batches * item * (
        b * PROMPT * h * (2 * dh + rd)
        + steps * b * (PROMPT + STEPS) * (r + rd))
    del params
    assert graphs._HELD[0] is None
