"""The port's multimodal families against the JAX package: qwen2-vl-2b
(M-RoPE, prepended patch stubs) and seamless-m4t-medium (an encoder over
frame stubs, decoder blocks with cross-attention), reduced, in fp32 on
the JAX init, with the stubs of ``chip_smoke.family_extras``.

Beyond the whole-model checks of ``_family_checks``: ``apply_mrope`` and
the M-RoPE branch of ``gqa_attention``, ``encode``, ``extra_inputs``, and
two hazards of the reference that the port matches (ROADMAP.md): R7,
qwen2-vl's prefill rotates by plain RoPE where its decode step takes
M-RoPE, so prefill + decode is off the full forward in both packages;
R8, the microbatched train step fails with ``pos3`` or ``enc_feats`` in
the batch (the port raises ``ValueError`` before any work).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402
from _family_checks import (CHECKS, S, _batch_np, _batch_t,  # noqa: E402
                            check_cache_law, close, jax_decode, jax_logits,
                            jax_loss_and_grads, jax_prefill, pair,
                            port_logits)
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.optim import adamw_init  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

ARCHS = ("qwen2-vl-2b", "seamless-m4t-medium")


@pytest.mark.parametrize("check", sorted(CHECKS))
@pytest.mark.parametrize("arch", ARCHS)
def test_family_equals_jax(arch, check):
    CHECKS[check](arch)


def test_prefill_then_decode_reproduces_the_full_forward():
    """The cache law holds for seamless's text path (qwen2-vl's does not:
    R7, below)."""
    check_cache_law("seamless-m4t-medium")


# -- M-RoPE -------------------------------------------------------------------

@pytest.mark.parametrize("dh", [16, 32, 128])
def test_apply_mrope_equals_jax(dh):
    """Sections (2, 1, 1) of the rotary dim, each by its own stream."""
    rng = np.random.default_rng(dh)
    x = rng.normal(size=(2, 5, 3, dh)).astype(np.float32)
    pos3 = rng.integers(0, 4096, size=(3, 2, 5))
    close(L.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), 1e6),
          RL.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6), 1e-5)


def test_gqa_attention_with_mrope_equals_jax():
    """qwen2-vl's attention with ``pos3`` (the M-RoPE branch) and
    without (plain RoPE over ``positions``), from a cache at index 0 and
    without one."""
    pr = pair("qwen2-vl-2b")
    tree = jax.tree_util.tree_map(lambda a: a[0],
                                  pr.tree["segments"][0]["attn"])
    p_j = {k: jnp.asarray(v) for k, v in tree.items()}
    p_t = {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}
    seq = pr.seq
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, seq, pr.cfg_j.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(seq), (2, seq))
    pos3 = pr.extras["pos3"]
    attn_j = jax.jit(RL.gqa_attention, static_argnums=1)
    shape = (2, seq, pr.cfg_j.n_kv_heads, pr.cfg_j.head_dim)
    for p3 in (pos3, None):
        for cached in (False, True):
            cache_j = ({"k": jnp.zeros(shape), "v": jnp.zeros(shape),
                        "index": 0} if cached else None)
            cache_t = ({"k": torch.zeros(shape), "v": torch.zeros(shape),
                        "index": 0} if cached else None)
            want, _ = attn_j(p_j, pr.cfg_j, jnp.asarray(x), jnp.asarray(pos),
                             cache_j, None if p3 is None else jnp.asarray(p3))
            got, _ = L.gqa_attention(
                p_t, pr.cfg_t, torch.from_numpy(x),
                torch.from_numpy(pos.copy()), cache_t,
                pos3=None if p3 is None else torch.from_numpy(p3.copy()))
            close(got, want, 1e-5)


def test_family_extras_lay_the_patches_out_as_a_grid():
    cfg = pair("qwen2-vl-2b").cfg_t
    ex = pair("qwen2-vl-2b").extras
    n = ex["extra_embeds"].shape[1]
    pos3 = ex["pos3"]
    assert pos3.shape == (3, 2, n + 8) and pos3.dtype == np.int32
    assert (pos3[0, :, :n] == 0).all()
    assert pos3[1, 0, :n].tolist() == [i // 8 for i in range(n)]
    assert pos3[2, 0, :n].tolist() == [i % 8 for i in range(n)]
    for stream in pos3:
        assert stream[0, n:].tolist() == list(range(8, 16))
    assert ex["extra_embeds"].shape == (2, n, cfg.d_model)


# -- the encoder --------------------------------------------------------------

def test_encode_equals_jax():
    pr = pair("seamless-m4t-medium")
    feats = pr.extras["enc_feats"]
    pos = np.broadcast_to(np.arange(feats.shape[1]), feats.shape[:2])
    want = jax.jit(RM.encode, static_argnums=0)(
        pr.cfg_j, pr.p_j, jnp.asarray(feats), jnp.asarray(pos))
    got = M.encode(pr.cfg_t, pr.p_t, torch.from_numpy(feats),
                   torch.from_numpy(pos.copy()))
    assert len(pr.p_t["encoder"]) == pr.cfg_t.enc_layers == 2
    close(got, want, 1e-4)
    assert got.shape == feats.shape


@pytest.mark.parametrize("arch", ARCHS)
def test_extra_inputs_are_the_jax_packages(arch):
    cfg = pair(arch).cfg_t
    want = ref_steps.extra_inputs(pair(arch).cfg_j, 4, 32)
    got = steps.extra_inputs(cfg, 4, 32)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert got[k].device.type == "meta"
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)


def test_seamless_without_frames_gets_zero_encoder_gradients():
    """Without ``enc_feats`` the loss reaches neither the encoder nor the
    cross-attention: their gradients are zeros, as under ``jax.grad``,
    and the rest agree."""
    pr = pair("seamless-m4t-medium")
    loss_j, grads_j, batch = jax_loss_and_grads("seamless-m4t-medium",
                                                False)
    assert "enc_feats" not in batch
    loss_t, grads_t = steps.loss_and_grads(pr.cfg_t, pr.p_t, _batch_t(batch))
    assert abs(float(loss_t) - loss_j) <= 1e-5
    unused = pytree.tree_leaves(grads_t["encoder"]) + [
        g for layer in grads_t["layers"]
        for g in pytree.tree_leaves({k: layer[k]
                                     for k in ("xattn", "lnx")})]
    assert len(unused) == 2 * 9 + pr.cfg_t.n_layers * 5
    assert all(bool((g == 0).all()) for g in unused)
    assert all(not np.any(g) for g in
               jax.tree_util.tree_leaves(grads_j["encoder"]))
    want = M.params_from_numpy(pr.cfg_t, grads_j, "cpu")
    for got, exp in zip(pytree.tree_leaves(grads_t),
                        pytree.tree_leaves(want)):
        torch.testing.assert_close(got, exp, atol=1e-5, rtol=1e-5)


# -- the reference's hazards, matched -----------------------------------------

def test_r7_qwen2_vl_prefill_and_decode_rotate_differently():
    """R7: the serving path's prefill passes no ``pos3`` (plain RoPE),
    its decode step builds one (M-RoPE, every stream at ``index``).  The
    port gives the JAX package's prefill + decode logits, and in both
    they are off the full forward's last logits, with ``pos3`` or
    without."""
    pr = pair("qwen2-vl-2b")
    tok = pr.tokens[:, :S]
    caches_j = RM.init_cache(pr.cfg_j, 2, S)
    _, caches_j = jax_prefill(pr.cfg_j, pr.p_j, jnp.asarray(tok[:, :-1]),
                              caches_j)
    dec_j, _ = jax_decode(pr.cfg_j, pr.p_j, jnp.asarray(tok[:, -1]), S - 1,
                          caches_j)
    caches_t = M.init_cache(pr.cfg_t, 2, S, "cpu")
    tok_t = torch.from_numpy(tok).long()
    _, caches_t = M.prefill(pr.cfg_t, pr.p_t, tok_t[:, :-1], caches_t)
    dec_t, _ = M.decode_step(pr.cfg_t, pr.p_t, tok_t[:, -1], S - 1,
                             caches_t)
    close(dec_t, dec_j, 1e-4)
    arange3 = np.broadcast_to(np.arange(S), (3, 2, S)).astype(np.int32)
    for pos3 in (None, arange3):
        full_j = np.asarray(jax_logits(
            pr.cfg_j, pr.p_j, jnp.asarray(tok),
            pos3=None if pos3 is None else jnp.asarray(pos3)))[:, -1]
        full_t = port_logits(pr.cfg_t, pr.p_t, tok_t, pos3=None
                             if pos3 is None else torch.from_numpy(pos3)
                             )[:, -1].numpy()
        np.testing.assert_allclose(full_t, full_j, atol=1e-4, rtol=1e-4)
        assert np.abs(np.asarray(dec_j) - full_j).max() > 0.05
        assert np.abs(dec_t.numpy() - full_t).max() > 0.05


@pytest.mark.parametrize("arch", ARCHS)
def test_r8_microbatches_with_pos3_or_frames_fail_in_both(arch):
    """R8: the JAX package's microbatch loop slices ``tokens``, ``labels``
    and ``extra_embeds`` but passes ``pos3`` and ``enc_feats`` whole, and
    fails; the port raises ``ValueError`` before any work (it would
    otherwise cut ``pos3 [3, B, S]`` along its stream axis)."""
    pr = pair(arch)
    batch = _batch_np(pr, 13)
    step_j = jax.jit(ref_steps.build_train_step(pr.cfg_j, total_steps=3,
                                                microbatches=2))
    with pytest.raises((TypeError, ValueError)):
        step_j(pr.p_j, adamw_init(pr.p_j),
               {k: jnp.asarray(v) for k, v in batch.items()})
    step_t = steps.build_train_step(pr.cfg_t, total_steps=3, microbatches=2)
    opt = optim.adamw_init(pr.p_t)
    with pytest.raises(ValueError, match="microbatches=2"):
        step_t(pr.p_t, opt, _batch_t(batch))
    assert int(opt.step) == 0
    # whole, the same batch steps in both
    step_t = steps.build_train_step(pr.cfg_t, total_steps=3)
    _, _, metrics = step_t(pr.p_t, opt, _batch_t(batch))
    assert np.isfinite(float(metrics["loss"]))
