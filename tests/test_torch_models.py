"""The port's LM model stack against the JAX package's: the config copies,
every config's parameters and caches, the dense layers, and the whole
dense model (forward, prefill, decode) on the JAX package's own initial
parameters, carried across with ``params_from_numpy`` (the other families:
``tests/test_torch_{moe,ssm,families}.py``).

Tolerances: layers 1e-5 and whole-model logits 1e-4, fp32 on the CPU; the
two frameworks sum matrix products and softmaxes in different orders, and
the port's prefill attends through the flash-attention kernel's plain
version where JAX takes a masked softmax over the whole cache (the empty
slots weigh exactly 0).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402
from _lm_reference import (DENSE_ARCHS, as_port_fields, jax_config,  # noqa: E402
                           jax_params)
from repro import configs as repro_configs  # noqa: E402
from repro.models import config as repro_config  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

ALL_ARCHS = repro_configs.ARCHS + repro_configs.PAPER_ARCHS
B, S, STEPS = 2, 8, 4

# the JAX package's functions, compiled once per config (eager JAX
# dispatches op by op, which is slow on the CPU)
jax_attention = jax.jit(RL.gqa_attention, static_argnums=1,
                        static_argnames="causal")
jax_forward_logits = jax.jit(
    lambda cfg, p, tokens, pos: RM.logits_of(
        cfg, p, RM.forward(cfg, p, RM.embed(cfg, p, tokens), pos)[0]),
    static_argnums=0)
jax_prefill = jax.jit(RM.prefill, static_argnums=0)
jax_decode = jax.jit(RM.decode_step, static_argnums=0)


def _port_config(arch, dtype="float32"):
    return dataclasses.replace(configs.get(arch).reduced(), dtype=dtype)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


# -- configs ------------------------------------------------------------------

# the port's own fields, after the JAX package's: a leading dense stack,
# DeepSeek-V2's routing over a held share of the experts, and YaRN
PORT_FIELDS = ("first_dense", "router_experts", "expert_offset", "n_group",
               "topk_group", "routed_scaling", "yarn_factor",
               "yarn_original_max", "yarn_beta_fast", "yarn_beta_slow",
               "yarn_mscale", "yarn_mscale_all_dim")


def test_arch_config_schema_is_the_jax_packages():
    """Every field of the JAX package's schema, in its order, with its
    type and default; then the port's own fields."""
    fields = [(f.name, f.type, f.default)
              for f in dataclasses.fields(config.ArchConfig)]
    jax_fields = [(f.name, f.type, f.default)
                  for f in dataclasses.fields(repro_config.ArchConfig)]
    assert fields[:len(jax_fields)] == jax_fields
    assert tuple(f[0] for f in fields[len(jax_fields):]) == PORT_FIELDS
    assert configs.ARCHS == repro_configs.ARCHS
    assert configs.PAPER_ARCHS == repro_configs.PAPER_ARCHS


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_every_config_equals_the_jax_packages(arch):
    """Each shipped config holds the JAX package's values in every JAX
    field and the defaults in the port's own, and so has its pattern,
    parameter count and reduced config (the defaults change none)."""
    mine, theirs = configs.get(arch), repro_configs.get(arch)
    for a, b in ((mine, theirs), (mine.reduced(), theirs.reduced())):
        assert dataclasses.asdict(a) == as_port_fields(b)
        assert a.head_dim == b.head_dim and a.pattern == b.pattern
        assert a.param_count() == b.param_count()
        assert not a.held_experts
        assert a.active_param_count() == b.active_param_count()
        assert a.sub_quadratic == b.sub_quadratic


def test_every_dense_config_runs():
    """The dense configs this file holds against the JAX package are
    dense, and each builds its parameters and cache on the CPU."""
    dense = [a for a in ALL_ARCHS if repro_configs.get(a).family == "dense"]
    assert set(DENSE_ARCHS) <= set(dense)
    for arch in dense:
        cfg = configs.get(arch).reduced()
        p = M.init_params(cfg, torch.Generator().manual_seed(0))
        assert len(p["layers"]) == cfg.n_layers
        assert len(M.init_cache(cfg, 1, 4, "cpu")) == cfg.n_layers


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_every_config_builds_its_cache_and_parameters(arch):
    """All eleven configs, reduced, on the CPU: one layer entry and one
    cache or state per block of the pattern, the shared block and the
    encoder where the config has them, and the parameter tree of the
    JAX package's init (the same leaves with the same shapes, through
    ``params_from_numpy``)."""
    cfg = configs.get(arch).reduced()
    p = M.init_params(cfg, torch.Generator().manual_seed(0))
    assert len(p["layers"]) == len(M.init_cache(cfg, 1, 4, "cpu")) == len(
        cfg.pattern)
    assert ("shared_attn" in p) == bool(cfg.shared_attn_every)
    assert len(p.get("encoder", [])) == cfg.enc_layers
    shapes = jax.eval_shape(lambda k: RM.init_params(
        repro_configs.get(arch).reduced(), k), jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32),
                                  shapes)
    want = M.params_from_numpy(cfg, tree, "meta")

    def leaves(params):
        flat, _ = pytree.tree_flatten_with_path(params)
        return {pytree.keystr(path): (t.shape, t.dtype) for path, t in flat}
    assert leaves(p) == leaves(want)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_every_config_runs_every_entry_point(arch):
    """All eleven configs, reduced, on the CPU, with the stubs
    ``extra_inputs`` describes: ``forward``, the prefill and serve steps
    (decode cross-attending to ``encode`` where there are frames), and
    one train step of ``lm_loss``; every output finite."""
    from repro_torch.launch import steps
    from repro_torch.optim import adamw_init
    cfg = configs.get(arch).reduced()
    p = M.init_params(cfg, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab, (B, S), generator=g)
    extras = {k: (torch.randn(v.shape, generator=g)
                  if v.dtype.is_floating_point
                  else torch.arange(v.shape[-1]).expand(v.shape))
              for k, v in steps.extra_inputs(cfg, B, S).items()}
    seq = S + (extras["extra_embeds"].shape[1] if "extra_embeds" in extras
               else 0)
    h, _ = M.forward(cfg, p, M.embed(cfg, p, tok),
                     torch.arange(S).expand(B, S))
    assert h.shape == (B, S, cfg.d_model) and torch.isfinite(h).all()
    caches = M.init_cache(cfg, B, seq + 1, "cpu")
    logits, caches = steps.build_prefill_step(cfg)(
        p, caches, dict(extras, tokens=tok))
    enc_out = None
    if "enc_feats" in extras:
        feats = extras["enc_feats"].to(M.torch_dtype(cfg))
        enc_out = M.encode(cfg, p, feats, torch.arange(
            feats.shape[1]).expand(feats.shape[:2]))
    step_logits, _ = steps.build_serve_step(cfg)(
        p, caches, logits[:, -1].argmax(-1), seq, enc_out)
    assert step_logits.shape == (B, cfg.vocab)
    assert torch.isfinite(logits).all() and torch.isfinite(step_logits).all()
    _, _, metrics = steps.build_train_step(cfg, 3)(
        p, adamw_init(p), dict(extras, tokens=tok, labels=tok))
    assert np.isfinite(float(metrics["loss"]))


# -- layers -------------------------------------------------------------------

def test_rmsnorm_and_rope_equal_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    g = rng.normal(size=(16,)).astype(np.float32)
    _close(L.rmsnorm(_t(x), _t(g), 1e-6),
           RL.rmsnorm(jnp.asarray(x), jnp.asarray(g), 1e-6), 1e-5)
    pos = rng.integers(0, 4096, size=(2, 5))
    _close(L.apply_rope(_t(x), torch.from_numpy(pos), 10_000.0),
           RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0), 1e-5)
    _close(L.apply_rope(_t(x), torch.from_numpy(pos), 1e6),
           RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6), 1e-5)


def test_mlp_equals_jax():
    rng = np.random.default_rng(1)
    p = {k: rng.normal(size=shape).astype(np.float32) / 8
         for k, shape in (("w1", (64, 128)), ("w3", (64, 128)),
                          ("w2", (128, 64)))}
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    _close(L.mlp_apply({k: _t(v) for k, v in p.items()}, _t(x)),
           RL.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x)), 1e-5)


def _attn_case(arch, seed):
    """A layer's attention parameters from the JAX init, an input, and
    both configs."""
    cfg_j, cfg_t = jax_config(arch), _port_config(arch)
    tree = jax.tree_util.tree_map(lambda a: a[0],
                                  jax_params(arch)["segments"][0]["attn"])
    x = np.random.default_rng(seed).normal(
        size=(B, S, cfg_j.d_model)).astype(np.float32)
    return (cfg_j, {k: jnp.asarray(v) for k, v in tree.items()},
            cfg_t, {k: _t(v) for k, v in tree.items()}, x)


@pytest.mark.parametrize("kind", ["causal", "bidirectional", "cross"])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen3-4b"])
def test_gqa_attention_without_cache_equals_jax(arch, kind):
    """n_rep 4 (tinyllama) and qk-norm (qwen3); causal self-attention,
    bidirectional, and cross-attention through ``kv_source``."""
    cfg_j, p_j, cfg_t, p_t, x = _attn_case(arch, 2)
    assert cfg_t.n_heads // cfg_t.n_kv_heads > 1
    pos = np.broadcast_to(np.arange(S), (B, S))
    src = np.random.default_rng(3).normal(
        size=(B, 5, cfg_j.d_model)).astype(np.float32)
    kw_j, kw_t = {"causal": ({}, {}),
                  "bidirectional": ({"causal": False}, {"causal": False}),
                  "cross": ({"kv_source": jnp.asarray(src)},
                            {"kv_source": _t(src)})}[kind]
    want, _ = jax_attention(p_j, cfg_j, jnp.asarray(x), jnp.asarray(pos),
                            **kw_j)
    got, cache = L.gqa_attention(p_t, cfg_t, _t(x),
                                 torch.from_numpy(pos.copy()), **kw_t)
    assert cache is None
    _close(got, want, 1e-5)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen3-4b"])
def test_gqa_attention_with_cache_equals_jax(arch):
    """The cache branch: a prompt written at index 0 (through the kernel's
    plain version in the port), then one token at index S (the masked
    product over the cache); the cache written in place."""
    cfg_j, p_j, cfg_t, p_t, x = _attn_case(arch, 4)
    smax = S + 3
    shape = (B, smax, cfg_j.n_kv_heads, cfg_j.head_dim)
    cache_j = {"k": jnp.zeros(shape), "v": jnp.zeros(shape), "index": 0}
    cache_t = {"k": torch.zeros(shape), "v": torch.zeros(shape), "index": 0}
    pos = np.broadcast_to(np.arange(S), (B, S))
    before = ops.launch_counts()
    want, cache_j = jax_attention(p_j, cfg_j, jnp.asarray(x),
                                  jnp.asarray(pos), cache_j)
    got, new_t = L.gqa_attention(p_t, cfg_t, _t(x),
                                 torch.from_numpy(pos.copy()), cache_t)
    _close(got, want, 1e-5)
    assert new_t["k"] is cache_t["k"] and new_t["index"] == S
    _close(new_t["k"], cache_j["k"], 1e-5)
    _close(new_t["v"], cache_j["v"], 1e-5)
    x1 = np.random.default_rng(5).normal(
        size=(B, 1, cfg_j.d_model)).astype(np.float32)
    pos1 = np.full((B, 1), S)
    want, _ = jax_attention(p_j, cfg_j, jnp.asarray(x1),
                            jnp.asarray(pos1), cache_j)
    got, _ = L.gqa_attention(p_t, cfg_t, _t(x1), torch.from_numpy(pos1),
                             new_t)
    _close(got, want, 1e-5)
    assert ops.launch_counts() == before


# -- the whole dense model ----------------------------------------------------

@pytest.fixture(scope="module", params=DENSE_ARCHS)
def model_pair(request):
    """(port cfg, port params, JAX cfg, JAX params, tokens [B, S + STEPS])
    for one reduced dense arch in fp32, on the JAX init."""
    arch = request.param
    cfg_j, cfg_t = jax_config(arch), _port_config(arch)
    tree = jax_params(arch)
    tokens = np.random.default_rng(6).integers(
        0, cfg_j.vocab, (B, S + STEPS), dtype=np.int32)
    return (cfg_t, M.params_from_numpy(cfg_t, tree, "cpu"), cfg_j,
            jax.tree_util.tree_map(jnp.asarray, tree), tokens)


def test_full_forward_logits_equal_jax(model_pair):
    cfg_t, p_t, cfg_j, p_j, tokens = model_pair
    pos = np.broadcast_to(np.arange(S), (B, S))
    want = jax_forward_logits(cfg_j, p_j, jnp.asarray(tokens[:, :S]),
                              jnp.asarray(pos))
    tok = torch.from_numpy(tokens[:, :S]).long()
    got, caches = M.forward(cfg_t, p_t, M.embed(cfg_t, p_t, tok),
                            torch.from_numpy(pos.copy()))
    assert caches is None
    _close(M.logits_of(cfg_t, p_t, got), want, 1e-4)


def test_prefill_and_decode_logits_equal_jax(model_pair):
    """Prefill of S tokens, then STEPS decode steps on the prompt's own
    continuation: every step's logits, and the greedy tokens of each."""
    cfg_t, p_t, cfg_j, p_j, tokens = model_pair
    caches_j = RM.init_cache(cfg_j, B, S + STEPS)
    caches_t = M.init_cache(cfg_t, B, S + STEPS, "cpu")
    want, caches_j = jax_prefill(cfg_j, p_j, jnp.asarray(tokens[:, :S]),
                                 caches_j)
    got, caches_t = M.prefill(cfg_t, p_t, torch.from_numpy(
        tokens[:, :S]).long(), caches_t)
    assert got.shape == (B, 1, cfg_t.vocab)
    _close(got, want, 1e-4)
    for step in range(STEPS):
        assert np.array_equal(got.argmax(-1).numpy().ravel(),
                              np.asarray(jnp.argmax(want, -1)).ravel())
        tok = tokens[:, S + step]
        want, caches_j = jax_decode(cfg_j, p_j, jnp.asarray(tok),
                                    S + step, caches_j)
        got, caches_t = M.decode_step(cfg_t, p_t,
                                      torch.from_numpy(tok).long(),
                                      S + step, caches_t)
        assert got.shape == (B, cfg_t.vocab)
        _close(got, want, 1e-4)


def test_prefill_then_decode_reproduces_the_full_forward(model_pair):
    """tests/test_models.py's cache law, in the port, in fp32: prefill of
    S - 1 tokens and one decode step give the full forward's last
    logits."""
    cfg_t, p_t, _, _, tokens = model_pair
    tok = torch.from_numpy(tokens[:, :S]).long()
    h, _ = M.forward(cfg_t, p_t, M.embed(cfg_t, p_t, tok),
                     torch.arange(S).expand(B, S))
    full = M.logits_of(cfg_t, p_t, h)[:, -1]
    caches = M.init_cache(cfg_t, B, S + 4, "cpu")
    _, caches = M.prefill(cfg_t, p_t, tok[:, :-1], caches)
    dec, _ = M.decode_step(cfg_t, p_t, tok[:, -1], S - 1, caches)
    torch.testing.assert_close(dec, full, atol=1e-4, rtol=1e-4)


def test_params_from_numpy_takes_bf16_trees_exactly():
    """A bf16 JAX tree (numpy leaves of ml_dtypes' bfloat16, which
    ``torch.from_numpy`` refuses) arrives exactly, through fp32."""
    arch = "tinyllama-1.1b"
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), jax_params(arch))
    cfg = configs.get(arch).reduced()
    assert cfg.dtype == "bfloat16"
    p = M.params_from_numpy(cfg, tree, "cpu")
    assert p["emb"].dtype == torch.bfloat16
    assert len(p["layers"]) == cfg.n_layers
    wq = tree["segments"][0]["attn"]["wq"]
    assert np.array_equal(p["layers"][-1]["attn"]["wq"].float().numpy(),
                          wq[-1].astype(np.float32))
    assert np.array_equal(p["unemb"].float().numpy(),
                          tree["unemb"].astype(np.float32))
    p32 = M.params_from_numpy(cfg, tree, "cpu", torch.float32)
    assert p32["layers"][0]["mlp"]["w2"].dtype == torch.float32
    assert torch.equal(p32["emb"], p["emb"].float())


# -- lm_loss, gradients and train steps of the dense configs -----------------

@pytest.fixture
def one_thread():
    """torch on one thread for the test, restored after (as
    tests/test_torch_lm_train.py's fixture): at these sizes threads do
    not pay, and beside other test processes they thrash."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_dense_loss_and_every_gradient_equal_jax(arch, one_thread):
    """``lm_loss`` and every gradient within 1e-5
    (``tests/_family_checks.py``); the train steps of these configs are
    held in tests/test_torch_families_train.py and, for tinyllama-1.1b,
    tests/test_torch_lm_train.py."""
    from _family_checks import check_loss_and_gradients
    check_loss_and_gradients(arch)


def test_minicpm_wsd_train_steps_equal_jax(one_thread):
    """minicpm-2b trains with WSD: both packages' train steps at steps 10,
    11 and 12 of a 12-step schedule (10 warmup steps, 1 stable, 1 decay:
    the plateau, the decay's start and its floor) on the JAX init, from
    zero moments: the learning rates equal (and not the cosine
    schedule's), the other metrics within TRAIN_TOL."""
    import chip_smoke
    from _family_checks import _batch_np, _batch_t, pair
    from repro.launch.steps import build_train_step as ref_train_step
    from repro.optim import adamw as repro_adamw
    from repro_torch.launch.steps import build_train_step
    from repro_torch.launch.train import state_from_numpy
    from repro_torch.optim import make_schedule
    pr = pair("minicpm-2b")
    assert pr.cfg_t.schedule == "wsd"
    total, first = 12, 10
    step_j = jax.jit(ref_train_step(pr.cfg_j, total_steps=total,
                                    base_lr=1e-3))
    step_t = build_train_step(pr.cfg_t, total_steps=total, base_lr=1e-3)
    p_j = pr.p_j
    opt_j = repro_adamw.adamw_init(p_j)._replace(
        step=jnp.asarray(first, jnp.int32))
    zeros = jax.tree_util.tree_map(np.zeros_like, pr.tree)
    state = state_from_numpy(pr.cfg_t, pr.tree, repro_adamw.AdamWState(
        np.int32(first), zeros, zeros), "cpu")
    p_t, opt_t = state["params"], state["opt"]
    rates = []
    for seed in range(3):
        batch = _batch_np(pr, 20 + seed)
        new_j, opt_j, m_j = step_j(p_j, opt_j, {k: jnp.asarray(v)
                                                for k, v in batch.items()})
        new_t, opt_t, m_t = step_t(p_t, opt_t, _batch_t(batch))
        assert float(m_t["lr"]) == float(m_j["lr"])
        l1 = sum(float(np.abs(np.asarray(a, np.float64)
                              - np.asarray(b, np.float64)).sum())
                 for a, b in zip(jax.tree_util.tree_leaves(new_j),
                                 jax.tree_util.tree_leaves(p_j)))
        got = {"loss": float(m_t["loss"]), "lr": float(m_t["lr"]),
               "grad_norm": float(m_t["grad_norm"]),
               "step_l1": chip_smoke.step_l1(new_t, p_t)}
        want = {"loss": float(m_j["loss"]), "lr": float(m_j["lr"]),
                "grad_norm": float(m_j["grad_norm"]), "step_l1": l1}
        assert chip_smoke.train_metrics_within(got, want), (got, want)
        rates.append(float(m_t["lr"]))
        p_j, p_t = new_j, new_t
    cosine = make_schedule("cosine", 1e-3, total)
    assert rates != [float(cosine(s)) for s in range(first, first + 3)]
    assert rates == pytest.approx([1e-3, 1e-3, 1e-4])
