"""Checks shared by the LM-family tests (``tests/test_torch_moe.py``,
``test_torch_ssm.py``, ``test_torch_families.py``): one reduced arch in
fp32, on the JAX package's own initial parameters carried across with
``params_from_numpy``, through both packages' entry points, with the
modality stubs of ``chip_smoke.family_extras`` where the arch has a
frontend.

Tolerances: logits 1e-4 (as ``tests/test_torch_models.py``), ``lm_loss``
1e-5 and every gradient 1e-5 relative, and 1e-5 of the leaf's largest
magnitude where that is above 1 (``gradient_scale``), a train step's
metrics ``TRAIN_TOL``; the two frameworks sum products, softmaxes and
scans in different orders.
"""
import dataclasses
import functools
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch.utils import _pytree as pytree

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from _lm_reference import (as_port_fields, jax_config, jax_params,  # noqa: E402
                           serve_tokens)
from repro.launch.steps import build_train_step as ref_train_step  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.optim import adamw as repro_adamw  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.steps import build_train_step, loss_and_grads  # noqa: E402
from repro_torch.launch.train import state_from_numpy  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

B, S, STEPS = 2, 8, 3
# the stubs' seed, and the prompts'
EXTRAS_SEED, TOKENS_SEED = 7, 6
# zamba2 over a whole period of its pattern, so that the shared block runs
PATTERNS = {"zamba2-1.2b": chip_smoke.ZAMBA2_PERIOD}


def _jax_logits(cfg, p, tokens, extra_embeds=None, pos3=None,
                enc_feats=None):
    """The JAX package's full forward (``lm_loss``'s front end) to
    logits over every position, the stubs' included."""
    x = RM.embed(cfg, p, tokens)
    if extra_embeds is not None:
        x = jnp.concatenate([extra_embeds.astype(x.dtype), x], axis=1)
    b, s, _ = x.shape
    positions = jnp.broadcast_to(jnp.arange(s), (b, s))
    enc_out = None
    if cfg.enc_layers and enc_feats is not None:
        enc_out = RM.encode(cfg, p, enc_feats.astype(x.dtype),
                            jnp.broadcast_to(jnp.arange(enc_feats.shape[1]),
                                             enc_feats.shape[:2]))
    h, _ = RM.forward(cfg, p, x, positions, pos3=pos3, enc_out=enc_out)
    return RM.logits_of(cfg, p, h)


jax_logits = jax.jit(_jax_logits, static_argnums=0)
jax_prefill = jax.jit(RM.prefill, static_argnums=0)
jax_decode = jax.jit(RM.decode_step, static_argnums=0)
jax_encode = jax.jit(RM.encode, static_argnums=0)


def port_logits(cfg, p, tokens, extra_embeds=None, pos3=None,
                enc_feats=None):
    """The port's counterpart of ``_jax_logits``."""
    x, positions, enc_out = M._inputs(cfg, p, tokens, extra_embeds,
                                      enc_feats, flash=True)
    h, _ = M.forward(cfg, p, x, positions, pos3=pos3, enc_out=enc_out)
    return M.logits_of(cfg, p, h)


def port_config(arch, dtype="float32", pattern=None, **kw):
    cfg = dataclasses.replace(configs.get(arch).reduced(), dtype=dtype, **kw)
    if pattern is not None:
        cfg = dataclasses.replace(cfg, block_pattern=tuple(pattern),
                                  n_layers=len(pattern))
    return cfg


def close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


@dataclasses.dataclass
class Pair:
    """One reduced arch in both packages: configs, parameters (the JAX
    init), prompts [B, S + STEPS] and the stubs of a [B, S] prompt as
    numpy, torch and jnp."""
    arch: str
    cfg_t: object
    cfg_j: object
    tree: dict
    p_t: dict
    p_j: dict
    tokens: np.ndarray
    extras: dict

    def extras_t(self):
        return {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in self.extras.items()}

    def extras_j(self):
        return {k: jnp.asarray(v) for k, v in self.extras.items()}

    @property
    def seq(self):
        """The prompt's length with its patch stubs."""
        return S + (self.extras["extra_embeds"].shape[1]
                    if "extra_embeds" in self.extras else 0)


@functools.lru_cache(maxsize=None)
def pair(arch: str, pattern=None) -> Pair:
    pattern = pattern or PATTERNS.get(arch)
    cfg_j = jax_config(arch, pattern=pattern)
    cfg_t = port_config(arch, pattern=pattern)
    assert dataclasses.asdict(cfg_t) == as_port_fields(cfg_j)
    tree = jax_params(arch, pattern=pattern)
    tokens = np.random.default_rng(TOKENS_SEED).integers(
        0, cfg_j.vocab, (B, S + STEPS), dtype=np.int32)
    return Pair(arch, cfg_t, cfg_j, tree,
                M.params_from_numpy(cfg_t, tree, "cpu"),
                jax.tree_util.tree_map(jnp.asarray, tree), tokens,
                chip_smoke.family_extras(cfg_t, B, S, EXTRAS_SEED))


# -- the checks -----------------------------------------------------------------

def check_full_forward(arch):
    """The full forward's logits at every position, stubs included."""
    pr = pair(arch)
    want = jax_logits(pr.cfg_j, pr.p_j, jnp.asarray(pr.tokens[:, :S]),
                      **pr.extras_j())
    got = port_logits(pr.cfg_t, pr.p_t,
                      torch.from_numpy(pr.tokens[:, :S]).long(),
                      **pr.extras_t())
    assert got.shape == (B, pr.seq, pr.cfg_t.vocab)
    close(got, want, 1e-4)


def check_prefill_and_decode(arch):
    """Prefill of S tokens with the stubs, then STEPS decode steps on the
    prompt's own continuation (cross-attending to the encoded frames,
    where there are any): every step's logits, and the greedy tokens."""
    pr = pair(arch)
    caches_j = RM.init_cache(pr.cfg_j, B, pr.seq + STEPS)
    caches_t = M.init_cache(pr.cfg_t, B, pr.seq + STEPS, "cpu")
    want, caches_j = jax_prefill(pr.cfg_j, pr.p_j,
                                 jnp.asarray(pr.tokens[:, :S]), caches_j,
                                 **pr.extras_j())
    got, caches_t = M.prefill(pr.cfg_t, pr.p_t,
                              torch.from_numpy(pr.tokens[:, :S]).long(),
                              caches_t, **pr.extras_t())
    assert got.shape == (B, 1, pr.cfg_t.vocab)
    close(got, want, 1e-4)
    enc_j = enc_t = None
    if "enc_feats" in pr.extras:
        feats = pr.extras["enc_feats"]
        pos = np.broadcast_to(np.arange(feats.shape[1]), feats.shape[:2])
        enc_j = jax_encode(pr.cfg_j, pr.p_j, jnp.asarray(feats),
                           jnp.asarray(pos))
        enc_t = M.encode(pr.cfg_t, pr.p_t, torch.from_numpy(feats),
                         torch.from_numpy(pos.copy()))
        close(enc_t, enc_j, 1e-4)
    for step in range(STEPS):
        assert np.array_equal(got.argmax(-1).numpy().ravel(),
                              np.asarray(jnp.argmax(want, -1)).ravel())
        tok = pr.tokens[:, S + step]
        want, caches_j = jax_decode(pr.cfg_j, pr.p_j, jnp.asarray(tok),
                                    pr.seq + step, caches_j, enc_out=enc_j)
        got, caches_t = M.decode_step(pr.cfg_t, pr.p_t,
                                      torch.from_numpy(tok).long(),
                                      pr.seq + step, caches_t,
                                      enc_out=enc_t)
        assert got.shape == (B, pr.cfg_t.vocab)
        close(got, want, 1e-4)


def check_cache_law(arch):
    """tests/test_models.py's cache law, in the port, in fp32: prefill of
    S - 1 tokens and one decode step give the full forward's last
    logits (no stubs: the law holds for the text path)."""
    pr = pair(arch)
    tok = torch.from_numpy(pr.tokens[:, :S]).long()
    full = port_logits(pr.cfg_t, pr.p_t, tok)[:, -1]
    caches = M.init_cache(pr.cfg_t, B, S + 2, "cpu")
    _, caches = M.prefill(pr.cfg_t, pr.p_t, tok[:, :-1], caches)
    dec, _ = M.decode_step(pr.cfg_t, pr.p_t, tok[:, -1], S - 1, caches)
    torch.testing.assert_close(dec, full, atol=1e-4, rtol=1e-4)


# three requests in batches of two: a full batch, then a ragged one
N_REQUESTS, PROMPT, MAX_NEW = 3, 8, 4


def check_serving_loop(arch):
    """The port's serving loop and the JAX package's give the same greedy
    tokens on the same prompts (no stubs: neither loop passes any), and
    launch nothing on the CPU."""
    pr = pair(arch)
    requests = serve.make_requests(pr.cfg_t, N_REQUESTS, PROMPT, MAX_NEW,
                                   seed=3)
    want = serve_tokens(pr.cfg_j, pr.tree, [r.prompt for r in requests],
                        2, PROMPT, MAX_NEW)
    before = ops.launch_counts()
    done = serve.serve_requests(pr.cfg_t, pr.p_t, requests, 2, PROMPT,
                                MAX_NEW, "cpu")
    assert ops.launch_counts() == before
    assert [r.generated for r in done] == want


def _batch_np(pr, seed):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, pr.cfg_j.vocab, (B, S), dtype=np.int32)
    lab = rng.integers(0, pr.cfg_j.vocab, (B, S), dtype=np.int32)
    return dict(pr.extras, tokens=tok, labels=lab)


def _batch_t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).long()
            if k in ("tokens", "labels") else
            torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def jax_loss_and_grads(arch, with_extras=True, pattern=None):
    """jax.value_and_grad of the JAX package's lm_loss on ``_batch_np``
    (with or without the stubs) for ``pair(arch, pattern)``: (loss, numpy
    grads, the batch)."""
    pr = pair(arch, pattern)
    batch = _batch_np(pr, 11)
    if not with_extras:
        batch = {k: batch[k] for k in ("tokens", "labels")}

    def loss_of(p, b):
        return RM.lm_loss(pr.cfg_j, p, b["tokens"], b["labels"],
                          extra_embeds=b.get("extra_embeds"),
                          pos3=b.get("pos3"), enc_feats=b.get("enc_feats"))
    loss, grads = jax.jit(jax.value_and_grad(loss_of))(
        pr.p_j, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), jax.tree_util.tree_map(np.asarray, grads), batch


def gradient_scale(g) -> float:
    """A gradient leaf's largest magnitude.  A leaf that sums many terms
    (the tied embedding's, over every position and the vocabulary) is
    held within 1e-5 of it: the two frameworks' fp32 sums differ by a few
    ulp of the leaf's scale, which exceeds 1e-5 of an element near 0 on
    a model that amplifies rounding from layer to layer (the reduced
    zamba2: 5.6e-6 of its embedding gradient's scale)."""
    return float(g.abs().max())


def check_loss_and_gradients(arch):
    """``lm_loss`` with the stubs and its gradient with respect to every
    parameter, against ``jax.value_and_grad``."""
    pr = pair(arch)
    loss_j, grads_j, batch = jax_loss_and_grads(arch)
    loss_t, grads_t = loss_and_grads(pr.cfg_t, pr.p_t, _batch_t(batch))
    assert abs(float(loss_t) - loss_j) <= 1e-5
    want = M.params_from_numpy(pr.cfg_t, grads_j, "cpu")
    got_leaves, want_leaves = (pytree.tree_leaves(grads_t),
                               pytree.tree_leaves(want))
    assert len(got_leaves) == len(want_leaves) == len(
        pytree.tree_leaves(pr.p_t))
    for got, exp in zip(got_leaves, want_leaves):
        assert got.dtype == exp.dtype and got.shape == exp.shape
        torch.testing.assert_close(got, exp, rtol=1e-5,
                                   atol=1e-5 * max(1.0, gradient_scale(exp)))


def check_train_step(arch):
    """One AdamW step of both packages' train steps from zero moments, on
    a batch with the stubs: loss, lr, gradient norm and the update's L1
    norm within TRAIN_TOL."""
    pr = pair(arch)
    batch = _batch_np(pr, 12)
    step_j = jax.jit(ref_train_step(pr.cfg_j, total_steps=3, base_lr=1e-3))
    new_j, _, m_j = step_j(pr.p_j, repro_adamw.adamw_init(pr.p_j),
                           {k: jnp.asarray(v) for k, v in batch.items()})
    zeros = jax.tree_util.tree_map(np.zeros_like, pr.tree)
    state = state_from_numpy(pr.cfg_t, pr.tree, repro_adamw.AdamWState(
        np.int32(0), zeros, zeros), "cpu")
    step_t = build_train_step(pr.cfg_t, total_steps=3, base_lr=1e-3)
    new_t, _, m_t = step_t(state["params"], state["opt"], _batch_t(batch))
    l1 = sum(float(np.abs(np.asarray(a, np.float64)
                          - np.asarray(b, np.float64)).sum())
             for a, b in zip(jax.tree_util.tree_leaves(new_j),
                             jax.tree_util.tree_leaves(pr.p_j)))
    got = {"loss": float(m_t["loss"]), "lr": float(m_t["lr"]),
           "grad_norm": float(m_t["grad_norm"]),
           "step_l1": chip_smoke.step_l1(new_t, state["params"])}
    want = {"loss": float(m_j["loss"]), "lr": float(m_j["lr"]),
            "grad_norm": float(m_j["grad_norm"]), "step_l1": l1}
    assert chip_smoke.train_metrics_within(got, want), (got, want)


CHECKS = {"full_forward": check_full_forward,
          "prefill_and_decode": check_prefill_and_decode,
          "serving_loop": check_serving_loop,
          "loss_and_gradients": check_loss_and_gradients,
          "train_step": check_train_step}
