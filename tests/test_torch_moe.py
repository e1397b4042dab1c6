"""The port's MoE and MLA families against the JAX package: dbrx-132b
(top-k MoE) and deepseek-v2-236b (MLA, fine-grained MoE with a shared
expert), reduced, in fp32 on the JAX init.

Beyond the whole-model checks of ``_family_checks`` (logits 1e-4, loss
and every gradient 1e-5, a train step within TRAIN_TOL, the serving
loop's tokens equal): ``top_k``'s order of ties, ``moe_apply`` with and
without capacity drops and on tied gates (drop for drop), the
expert-parallel path (its per-device body against the JAX package's
``shard_map`` body, and ``moe_apply`` on a one-rank gloo mesh against the
single-device path), and ``mla_attention`` with and without its latent
cache.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from _family_checks import (CHECKS, check_cache_law, close,  # noqa: E402
                            pair, port_config)
from _lm_reference import jax_config  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

ARCHS = ("dbrx-132b", "deepseek-v2-236b")
B_, S_ = 2, 8                      # the unit tests' batch and length

jax_moe = jax.jit(RL.moe_apply, static_argnums=1)
jax_mla = jax.jit(RL.mla_attention, static_argnums=1)


@pytest.mark.parametrize("check", sorted(CHECKS))
@pytest.mark.parametrize("arch", ARCHS)
def test_family_equals_jax(arch, check):
    CHECKS[check](arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_reproduces_the_full_forward(arch):
    check_cache_law(arch)


# -- routing ------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 4, 6])
def test_top_k_orders_ties_as_jax(k):
    """Gates of few distinct values tie often (as bf16 gates do): the
    port's stable sort takes the lower index first, as ``lax.top_k``."""
    gates = np.random.default_rng(k).integers(0, 3, (64, 16)).astype(
        np.float32)
    vals, idx = L.top_k(torch.from_numpy(gates), k)
    want_vals, want_idx = jax.lax.top_k(jnp.asarray(gates), k)
    assert np.array_equal(idx.numpy(), np.asarray(want_idx))
    assert np.array_equal(vals.numpy(), np.asarray(want_vals))


def _moe_layer(arch):
    """Layer 0's MoE parameters of the JAX init, in both packages."""
    pr = pair(arch)
    tree = jax.tree_util.tree_map(lambda a: a[0],
                                  pr.tree["segments"][0]["moe"])
    return (pr, jax.tree_util.tree_map(jnp.asarray, tree),
            M._map(lambda a, _: torch.from_numpy(np.array(a)), tree))


def _kept_from_jax_routing(top_idx, cap):
    """Which token-major (token, expert) pairs fit the capacity, from the
    JAX package's top-k choice: a pair's slot is the count of earlier
    pairs of its expert."""
    flat = np.asarray(top_idx).reshape(-1)
    seen, keep = {}, []
    for e in flat:
        keep.append(seen.get(e, 0) < cap)
        seen[e] = seen.get(e, 0) + 1
    return np.array(keep)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_equals_jax(arch):
    pr, p_j, p_t = _moe_layer(arch)
    x = np.random.default_rng(2).normal(
        size=(B_, S_, pr.cfg_j.d_model)).astype(np.float32)
    close(L.moe_apply(p_t, pr.cfg_t, torch.from_numpy(x)),
          jax_moe(p_j, pr.cfg_j, jnp.asarray(x)), 1e-5)


@pytest.mark.parametrize("tied", [False, True], ids=["skewed", "tied"])
def test_moe_capacity_drops_equal_jax_drop_for_drop(tied):
    """Reduced dbrx at B 2 x S 300: 1200 routed pairs > 1024, so the
    capacity bound (375 slots) applies.  Skewed: inputs that lean toward
    expert 0 overflow it.  Tied: a zero router ties every gate, and
    top-k takes experts 0 and 1 for every token.  The port drops the
    pairs the JAX package's routing drops, and the outputs agree."""
    pr, p_j, p_t = _moe_layer("dbrx-132b")
    cfg_j, cfg_t = pr.cfg_j, pr.cfg_t
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 300, cfg_j.d_model)).astype(np.float32)
    router = np.asarray(p_j["router"]).copy()
    if tied:
        router[:] = 0
    else:
        x += 0.5
        router[:, 0] += 0.05
    p_j = dict(p_j, router=jnp.asarray(router))
    p_t = dict(p_t, router=torch.from_numpy(router))
    t, k = 600, cfg_t.experts_per_tok
    cap = L.moe_capacity(t, k, cfg_t.n_experts)
    assert t * k > 1024 and cap == 375
    xf = x.reshape(t, -1)
    _, top_idx = jax.lax.top_k(jnp.asarray(xf) @ jnp.asarray(router), k)
    routing = L.moe_route(p_t, cfg_t, torch.from_numpy(xf))
    assert routing.capacity == cap
    assert np.array_equal(routing.flat_e.numpy(),
                          np.asarray(top_idx).reshape(-1))
    keep = _kept_from_jax_routing(top_idx, cap)
    assert np.array_equal(routing.keep.numpy(), keep)
    assert (~keep).sum() >= 200            # the bound did drop pairs
    if tied:
        assert set(np.asarray(top_idx).reshape(-1)) == {0, 1}
    close(L.moe_apply(p_t, cfg_t, torch.from_numpy(x)),
          jax_moe(p_j, cfg_j, jnp.asarray(x)), 1e-5)


def test_moe_init_stacks_the_experts():
    cfg = port_config("deepseek-v2-236b")
    p = L.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    ff = cfg.moe_d_ff
    assert p["router"].shape == (cfg.d_model, cfg.n_experts)
    assert p["experts"]["w1"].shape == (cfg.n_experts, cfg.d_model, ff)
    assert p["experts"]["w2"].shape == (cfg.n_experts, ff, cfg.d_model)
    assert p["shared"]["w1"].shape == (cfg.d_model,
                                       ff * cfg.n_shared_experts)
    assert not torch.equal(p["experts"]["w1"][0], p["experts"]["w1"][1])


# -- the expert-parallel path -------------------------------------------------

@pytest.mark.parametrize("data", [1, 2])
@pytest.mark.parametrize("model", [1, 2, 4])
def test_expert_parallel_body_equals_the_jax_shard_map_body(model, data):
    """The per-device body on each (data, model) shard of reduced
    deepseek-v2-236b's MoE (4 experts, top-2, d 320), its shares summed
    over the model shards, against the JAX package's
    ``_moe_dispatch_local`` body under ``jax.vmap(..., axis_name="model")``
    over the stacked expert shards (whose ``psum`` sums them), data shard
    by data shard; within 1e-6 of the output's largest magnitude in fp32
    (torch's bmm and XLA's dot sum in other orders).  64 tokens a data
    shard: the
    local capacity (max(8, int(1.25 * 64 * 2 / 4)) = 40 slots) drops
    pairs of the skewed routing."""
    pr, p_j, p_t = _moe_layer("deepseek-v2-236b")
    cfg_j, cfg_t = pr.cfg_j, pr.cfg_t
    e, k = cfg_t.n_experts, cfg_t.experts_per_tok
    rng = np.random.default_rng(10 * model + data)
    t_loc = 64
    xf = rng.normal(size=(data * t_loc, cfg_t.d_model)).astype(np.float32)
    gates = xf @ np.asarray(p_j["router"])
    gates[:, 0] += 0.5                    # lean toward expert 0
    top_vals, top_idx = jax.lax.top_k(jnp.asarray(gates), k)
    probs = np.asarray(jax.nn.softmax(top_vals, axis=-1))
    top_idx = np.array(top_idx)
    w = {n: np.asarray(p_j["experts"][n]) for n in ("w1", "w3", "w2")}
    ref_body = jax.jit(jax.vmap(RL._moe_dispatch_local(cfg_j, 1.25,
                                                       "model"),
                                in_axes=(None, None, None, 0, 0, 0),
                                axis_name="model"))
    body = L._moe_dispatch_local(cfg_t, 1.25)
    e_loc = e // model
    dropped = 0
    for d in range(data):
        rows = slice(d * t_loc, (d + 1) * t_loc)
        shards = {n: a.reshape((model, e_loc) + a.shape[1:])
                  for n, a in w.items()}
        want = np.asarray(ref_body(
            jnp.asarray(xf[rows]), jnp.asarray(top_idx[rows]),
            jnp.asarray(probs[rows]), jnp.asarray(shards["w1"]),
            jnp.asarray(shards["w3"]), jnp.asarray(shards["w2"])))
        got = sum(body(torch.from_numpy(xf[rows]),
                       torch.from_numpy(top_idx[rows]),
                       torch.from_numpy(probs[rows]),
                       *(torch.from_numpy(shards[n][m])
                         for n in ("w1", "w3", "w2")), m)
                  for m in range(model))
        scale = float(np.abs(want).max())
        for m in range(model):              # every model shard's psum
            np.testing.assert_allclose(got.numpy(), want[m], rtol=0,
                                       atol=1e-6 * scale)
        counts = np.bincount(top_idx[rows].reshape(-1), minlength=e)
        dropped += int(np.maximum(counts - 40, 0).sum())
    assert dropped > 0                       # the capacity bound applied


def test_moe_apply_on_a_one_rank_gloo_mesh_takes_the_expert_parallel_path():
    """``chip_smoke.moe_two_paths`` on the CPU: reduced deepseek-v2-236b
    at 2 x 300 tokens (t * k = 1200 > 1024, so both paths bound each
    expert at 375 slots), the single-device path and ``moe_apply`` on
    DTensors of a 1 x 1 mesh over a one-rank gloo group, bit for bit; the
    second goes through ``_moe_routed_sharded``."""
    import chip_smoke
    import torch.distributed as dist
    cfg = port_config("deepseek-v2-236b")
    p = chip_smoke.moe_layer(cfg, "cpu", torch.float32)
    x = torch.randn((2, 300, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    assert L.moe_capacity(600, cfg.experts_per_tok, cfg.n_experts) == 375
    calls = []
    sharded = L._moe_routed_sharded

    def spy(*args):
        out = sharded(*args)
        calls.append(out is not None)
        return out

    single, expert_parallel = chip_smoke.moe_two_paths(cfg, p, x, "gloo",
                                                       "cpu")
    try:
        L._moe_routed_sharded = spy
        ep = expert_parallel()
    finally:
        L._moe_routed_sharded = sharded
        dist.destroy_process_group()
    assert calls == [True]
    assert torch.equal(single, ep)
    assert not L.model_axis() and not L.data_axes()


def test_hints_do_nothing_to_plain_tensors():
    x = torch.randn(4, 8, 16)
    L.set_mesh_axes(("data",), "model")
    try:
        assert L.shard_tokens(x) is x
        assert L.shard_model_last(x) is x
        assert L._maybe_shard(x, (("data",), None, "model")) is x
        assert L._moe_routed_sharded({}, None, x[0], None, None,
                                     1.25) is None
    finally:
        L.set_mesh_axes((), None)


# -- MLA ----------------------------------------------------------------------

def _mla_layer():
    pr = pair("deepseek-v2-236b")
    tree = jax.tree_util.tree_map(lambda a: a[0],
                                  pr.tree["segments"][0]["attn"])
    return (pr, jax.tree_util.tree_map(jnp.asarray, tree),
            {k: torch.from_numpy(np.array(v)) for k, v in tree.items()})


@pytest.mark.parametrize("s", [8, 1024])
def test_mla_attention_without_cache_equals_jax(s):
    """One block, and at 1024 the q-block loop of SDPA_CHUNK rows (the
    reference's scan)."""
    pr, p_j, p_t = _mla_layer()
    b = 2 if s == 8 else 1
    x = np.random.default_rng(s).normal(
        size=(b, s, pr.cfg_j.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (b, s))
    want, _ = jax_mla(p_j, pr.cfg_j, jnp.asarray(x), jnp.asarray(pos))
    got, cache = L.mla_attention(p_t, pr.cfg_t, torch.from_numpy(x),
                                 torch.from_numpy(pos.copy()))
    assert cache is None
    close(got, want, 1e-5)


def test_mla_cache_holds_only_the_latent():
    """The cache of an MLA config is the latent and the rope key, no
    per-head keys or values; prefill writes it as the JAX package does,
    in place, and a decode step reads it back."""
    pr, p_j, p_t = _mla_layer()
    cfg = pr.cfg_t
    caches = M.init_cache(cfg, B_, S_ + 1, "cpu")
    assert len(caches) == len(cfg.pattern)
    for c in caches:
        assert set(c) == {"latent", "k_rope"}
        assert c["latent"].shape == (B_, S_ + 1, cfg.kv_lora_rank)
        assert c["k_rope"].shape == (B_, S_ + 1, cfg.rope_head_dim)
    shape = {"latent": (B_, S_ + 1, cfg.kv_lora_rank),
             "k_rope": (B_, S_ + 1, cfg.rope_head_dim)}
    cache_j = {k: jnp.zeros(v) for k, v in shape.items()}
    cache_t = {k: torch.zeros(v) for k, v in shape.items()}
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B_, S_, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S_), (B_, S_))
    want, cache_j = jax_mla(p_j, pr.cfg_j, jnp.asarray(x), jnp.asarray(pos),
                            dict(cache_j, index=0))
    got, new_t = L.mla_attention(p_t, cfg, torch.from_numpy(x),
                                 torch.from_numpy(pos.copy()),
                                 dict(cache_t, index=0))
    close(got, want, 1e-5)
    assert new_t["latent"] is cache_t["latent"] and new_t["index"] == S_
    for key in shape:
        close(new_t[key], cache_j[key], 1e-5)
    x1 = rng.normal(size=(B_, 1, cfg.d_model)).astype(np.float32)
    pos1 = np.full((B_, 1), S_)
    want, _ = jax_mla(p_j, pr.cfg_j, jnp.asarray(x1), jnp.asarray(pos1),
                      cache_j)
    got, _ = L.mla_attention(p_t, cfg, torch.from_numpy(x1),
                             torch.from_numpy(pos1), new_t)
    close(got, want, 1e-5)


def test_the_jax_mla_cache_is_the_ports():
    cfg_j = jax_config("deepseek-v2-236b")
    caches = RM.init_cache(cfg_j, B_, 4)
    mine = M.init_cache(port_config("deepseek-v2-236b"), B_, 4, "cpu")
    for seg, c in zip(caches, mine):
        assert set(seg) == set(c)
        for key in c:
            assert seg[key].shape[1:] == c[key].shape
