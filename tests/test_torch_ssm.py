"""The port's sub-quadratic families against the JAX package: zamba2-1.2b
(Mamba2 blocks and the shared attention block, over a whole period of its
pattern: the reduced config's first four blocks are all ``mamba``) and
xlstm-125m (mLSTM and sLSTM), reduced, in fp32 on the JAX init.

Beyond the whole-model checks of ``_family_checks``: ``softplus``, the
causal conv, each block continuing a recurrent state, the zero gradient
of a shared block the loss never reaches, and the xlstm training
restart of ``tests/test_train_integration.py`` under ``run_elastic``.
Then Mamba2's scan through ``ops.selective_scan`` (its plain version on
the CPU) against the training path and the JAX package, a shortened scan,
and which calls take which path (the ``ssm.scan_kernel_steps``
counter); the kernel itself is held to the plain version on the card in
``tests/test_torch_kernels.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402
from _family_checks import (CHECKS, _batch_t, check_cache_law,  # noqa: E402
                            close, jax_loss_and_grads, pair, port_config)
from repro_torch import spans  # noqa: E402
from repro_torch.kernels import ops, scan  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro.models import ssm as RS  # noqa: E402
from repro_torch.launch.elastic import run_elastic  # noqa: E402
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402

ARCHS = ("zamba2-1.2b", "xlstm-125m")


@pytest.mark.parametrize("check", sorted(CHECKS))
@pytest.mark.parametrize("arch", ARCHS)
def test_family_equals_jax(arch, check):
    CHECKS[check](arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_reproduces_the_full_forward(arch):
    check_cache_law(arch)


def test_the_shared_block_runs_in_the_pinned_pattern():
    """The period holds one ``sattn``, its parameters stored once; the
    layer list keeps an empty dict in its place and each shared block
    its own cache."""
    cfg = pair("zamba2-1.2b").cfg_t
    assert cfg.pattern.count("sattn") == 1 and cfg.shared_attn_every
    p = pair("zamba2-1.2b").p_t
    assert p["layers"][cfg.pattern.index("sattn")] == {}
    caches = M.init_cache(cfg, 1, 4, "cpu")
    assert set(caches[cfg.pattern.index("sattn")]) == {"k", "v"}
    assert set(caches[0]) == {"h", "conv"}
    assert caches[0]["h"].dtype == torch.float32


# -- the blocks ---------------------------------------------------------------

@pytest.mark.parametrize("scale", [1.0, 30.0])
def test_softplus_is_jaxs(scale):
    """``logaddexp(x, 0)``, also beyond torch's threshold of 20."""
    x = np.random.default_rng(0).normal(size=(256,)).astype(np.float32)
    x *= scale
    np.testing.assert_allclose(S.softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_equals_jax(dtype):
    """The K products summed from 0 in the working type: equal in fp32,
    within one bf16 rounding a sum in bf16."""
    rng = np.random.default_rng(1)
    u = rng.normal(size=(2, 7, 32)).astype(np.float32)
    w = rng.normal(size=(4, 32)).astype(np.float32)
    st = rng.normal(size=(2, 3, 32)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    for state in (None, st):
        got, got_state = S._causal_conv(
            torch.from_numpy(u).to(tdt), torch.from_numpy(w).to(tdt),
            None if state is None else torch.from_numpy(state).to(tdt))
        want, want_state = RS._causal_conv(
            jnp.asarray(u, jdt), jnp.asarray(w, jdt),
            None if state is None else jnp.asarray(state, jdt))
        assert got.dtype == tdt
        want = np.asarray(want, np.float32)
        if dtype == "float32":
            assert np.array_equal(got.numpy(), want)
        else:
            np.testing.assert_allclose(got.float().numpy(), want,
                                       rtol=2 ** -7, atol=2 ** -7)
        assert np.array_equal(got_state.float().numpy(),
                              np.asarray(want_state, np.float32))


def _block(arch, kind):
    """The first ``kind`` block's parameters of the JAX init."""
    pr = pair(arch)
    i = [k for k, _ in M.segments_of(pr.cfg_t)].index(kind)
    tree = jax.tree_util.tree_map(lambda a: a[0], pr.tree["segments"][i])
    return (pr, jax.tree_util.tree_map(jnp.asarray, tree),
            {k: torch.from_numpy(np.array(v)) for k, v in tree.items()})


@pytest.mark.parametrize("arch,kind", [("zamba2-1.2b", "mamba"),
                                       ("xlstm-125m", "mlstm"),
                                       ("xlstm-125m", "slstm")])
def test_block_continues_a_state_as_jax(arch, kind):
    """Five steps from the zero state, then three more from the state
    they left: outputs and every state tensor within 1e-5."""
    pr, p_j, p_t = _block(arch, kind)
    apply_j = jax.jit(getattr(RS, f"{kind}_apply"), static_argnums=1)
    apply_t = getattr(S, f"{kind}_apply")
    rng = np.random.default_rng(5)
    state_j = state_t = None
    for s in (5, 3):
        x = rng.normal(size=(2, s, pr.cfg_j.d_model)).astype(np.float32)
        want, state_j = apply_j(p_j, pr.cfg_j, jnp.asarray(x), state_j)
        got, state_t = apply_t(p_t, pr.cfg_t, torch.from_numpy(x), state_t)
        close(got, want, 1e-5)
        assert set(state_t) == set(state_j)
        for key in state_t:
            assert state_t[key].dtype == torch.float32 or key == "conv"
            close(state_t[key], state_j[key], 1e-5)


# -- gradients and training ---------------------------------------------------

def test_an_unused_shared_block_gets_zero_gradients():
    """The reduced zamba2 (four ``mamba`` blocks) holds the shared
    block's parameters but never runs them: their gradients are zeros,
    as under ``jax.grad`` (``torch.autograd.grad`` would raise)."""
    pattern = tuple(["mamba"] * 4)
    pr = pair("zamba2-1.2b", pattern=pattern)
    assert "sattn" not in pr.cfg_t.pattern and pr.cfg_t.shared_attn_every
    loss_j, grads_j, batch = jax_loss_and_grads("zamba2-1.2b", False,
                                                pattern)
    loss_t, grads_t = loss_and_grads(pr.cfg_t, pr.p_t, _batch_t(batch))
    assert abs(float(loss_t) - loss_j) <= 1e-5
    shared = pytree.tree_leaves(grads_t["shared_attn"])
    assert shared and all(bool((g == 0).all()) for g in shared)
    assert all(not np.any(g) for g in
               jax.tree_util.tree_leaves(grads_j["shared_attn"]))
    assert all(bool(g.abs().sum() > 0)
               for g in pytree.tree_leaves(grads_t["layers"]))


def test_xlstm_restart_under_run_elastic_is_bit_equal(tmp_path, capsys):
    """tests/test_train_integration.py's restart on xlstm-125m in the
    port: train 8 steps straight, and under ``run_elastic`` with a
    failure at step 5 and a resume from the last checkpoint; the final
    state and losses are equal to the bit."""
    kw = dict(steps=8, batch=4, seq=16, ckpt_every=2, reduced=True,
              log_every=1, device="cpu")
    straight = train("xlstm-125m", ckpt_dir=str(tmp_path / "a"), **kw)
    attempts, results = [], []

    def once(_resume_step):
        fail = None if attempts else 5
        attempts.append(fail)
        results.append(train("xlstm-125m", ckpt_dir=str(tmp_path / "b"),
                             fail_at=fail, **kw))
        return kw["steps"]

    run_elastic(once, max_restarts=1)
    assert attempts == [5, None]
    resumed = results[-1]
    assert "[train] resumed from checkpoint step 4" in capsys.readouterr().out
    assert resumed["losses"] == straight["losses"][4:]
    for a, b in zip(pytree.tree_leaves(straight["state"]),
                    pytree.tree_leaves(resumed["state"])):
        assert a.dtype == b.dtype and torch.equal(a, b)


# -- the scan through ops.selective_scan --------------------------------------

def _scan_inputs(s: int, seed: int = 0):
    """The reduced zamba2's first Mamba2 block (the JAX init, as numpy),
    its decay drawn to differ by channel, an input of ``s`` steps and a
    non-zero state."""
    pr = pair("zamba2-1.2b")
    _, p_j, p_t = _block("zamba2-1.2b", "mamba")
    cfg = pr.cfg_t
    di, n = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
    rng = np.random.default_rng(seed + s)
    a_log = (rng.normal(size=(di,)) * 0.5).astype(np.float32)
    p_j = dict(p_j, a_log=jnp.asarray(a_log))
    p_t = dict(p_t, a_log=torch.from_numpy(a_log))
    x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    state = {"h": rng.normal(size=(2, di, n)).astype(np.float32),
             "conv": rng.normal(size=(2, cfg.conv_kernel - 1, di))
             .astype(np.float32)}
    return pr, p_j, p_t, x, state


@pytest.mark.parametrize("s", [1, 7, 64])
def test_plain_selective_scan_equals_the_loop_bit_for_bit(s):
    """From one non-zero state, a no-grad block call (serving:
    ``ops.selective_scan``, its plain version on the CPU) and the same
    call with autograd recording (training: the loop of
    ``selective_scan_plain`` called directly) give outputs and states
    equal to the bit, nothing launched; both within 1e-5 of the JAX
    package's ``jax.lax.scan``."""
    pr, p_j, p_t, x, state = _scan_inputs(s)
    state_t = {k: torch.from_numpy(v) for k, v in state.items()}
    before = ops.launch_counts()
    with torch.no_grad():
        # a call through ops.selective_scan writes its state over the
        # given one
        got, got_state = S.mamba_apply(
            p_t, pr.cfg_t, torch.from_numpy(x),
            {k: v.clone() for k, v in state_t.items()})
    p_grad = {k: v.clone().requires_grad_() for k, v in p_t.items()}
    with spans.recording() as rec:
        want, want_state = S.mamba_apply(p_grad, pr.cfg_t,
                                         torch.from_numpy(x), state_t)
    assert want.requires_grad
    assert [c["name"] for c in rec.counters()] == ["ssm.scan_steps"]
    assert ops.launch_counts() == before
    assert torch.equal(got, want.detach())
    assert set(got_state) == set(want_state) == {"h", "conv"}
    for key in got_state:
        assert torch.equal(got_state[key], want_state[key].detach()), key
    ref, ref_state = jax.jit(RS.mamba_apply, static_argnums=1)(
        p_j, pr.cfg_j, jnp.asarray(x),
        {k: jnp.asarray(v) for k, v in state.items()})
    close(got, ref, 1e-5)
    for key in got_state:
        close(got_state[key], ref_state[key], 1e-5)


@pytest.mark.parametrize("steps", [1, 5])
def test_a_scan_limit_repeats_the_last_output(steps):
    """``selective_scan_plain(..., steps=k)`` (the dry-run's shortened
    scans): the first k outputs and the state those k steps leave equal
    to the bit the scan of just those steps, each later output the k-th
    one."""
    rng = np.random.default_rng(steps)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    dt, u, bmat, cmat = t(2, 9, 32).abs(), t(2, 9, 32), t(2, 9, 16), \
        t(2, 9, 16)
    a, h0 = -t(32).exp(), t(2, 32, 16)
    y, h = scan.selective_scan_plain(dt, u, bmat, cmat, a, h0, steps=steps)
    y_k, h_k = scan.selective_scan_plain(
        dt[:, :steps], u[:, :steps], bmat[:, :steps], cmat[:, :steps], a, h0)
    assert y.shape == (2, 9, 32) and torch.equal(h, h_k)
    assert torch.equal(y[:, :steps], y_k)
    assert torch.equal(y[:, steps:],
                       y_k[:, -1:].expand(2, 9 - steps, 32))


def test_selective_scan_refuses_autograd():
    """Forward only, as K6: a call autograd would record raises on every
    device; the same operands under ``no_grad`` pass."""
    rng = np.random.default_rng(2)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    dt, u, bmat, cmat, a, h0 = (t(2, 5, 32), t(2, 5, 32), t(2, 5, 16),
                                t(2, 5, 16), t(32), t(2, 32, 16))
    a.requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        ops.selective_scan(dt, u, bmat, cmat, a, h0)
    with torch.no_grad():
        y, h = ops.selective_scan(dt, u, bmat, cmat, a, h0)
    assert y.shape == (2, 5, 32) and h.shape == (2, 32, 16)


def _hybrid(dtype="float32"):
    """The reduced zamba2 over ``mamba, mamba, sattn, mamba``, torch
    init."""
    cfg = port_config("zamba2-1.2b", dtype=dtype,
                      pattern=("mamba", "mamba", "sattn", "mamba"))
    gen = torch.Generator()
    gen.manual_seed(0)
    return cfg, M.init_params(cfg, gen)


def _served_counts(cfg, params):
    """Each ``serve.prefill`` and ``serve.decode_step`` span's counters
    of a no-grad serving run of 2 requests, 6 prompt tokens, 4 new."""
    requests = serve.make_requests(cfg, 2, 6, 4, seed=1)
    with spans.recording() as rec, torch.no_grad():
        serve.serve_requests(cfg, params, requests, 2, 6, 4, "cpu")
    names = {s["id"]: s["name"] for s in rec.spans()}
    out = {"serve.prefill": [], "serve.decode_step": []}
    counts = {sid: {} for sid, name in names.items() if name in out}
    for c in rec.counters():
        if c["span"] in counts:
            counts[c["span"]][c["name"]] = c["value"]
    for sid in sorted(counts):
        out[names[sid]].append(counts[sid])
    return out


def test_a_no_grad_forward_scans_through_the_kernel_path():
    """Serving under ``no_grad``: every step of every Mamba2 scan, in
    prefill and in each decode step, goes through ``ops.selective_scan``
    (``ssm.scan_kernel_steps`` equals ``ssm.scan_steps``)."""
    cfg, params = _hybrid()
    counts = _served_counts(cfg, params)
    n_mamba = cfg.pattern.count("mamba")
    assert [c["ssm.scan_steps"] for c in counts["serve.prefill"]] == \
        [n_mamba * 6]
    assert [c["ssm.scan_steps"] for c in counts["serve.decode_step"]] == \
        [n_mamba] * 3
    for c in counts["serve.prefill"] + counts["serve.decode_step"]:
        assert c["ssm.scan_kernel_steps"] == c["ssm.scan_steps"]


def test_training_and_a_scan_limit_keep_the_loop():
    """A training step (autograd records) and a no-grad run under
    ``scan_steps`` scan through the loop: ``ssm.scan_kernel_steps`` is
    never counted, ``ssm.scan_steps`` is."""
    cfg, params = _hybrid()
    rng = np.random.default_rng(4)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 8)))
             for k in ("tokens", "labels")}
    with spans.recording() as rec:
        loss, grads = loss_and_grads(cfg, params, batch)
    totals = {}
    for c in rec.counters():
        totals[c["name"]] = totals.get(c["name"], 0) + c["value"]
    assert totals == {"ssm.scan_steps": cfg.pattern.count("mamba") * 8}
    assert bool(torch.isfinite(loss))
    with S.scan_steps(10 ** 6):
        counts = _served_counts(cfg, params)
    for c in counts["serve.prefill"] + counts["serve.decode_step"]:
        assert c["ssm.scan_steps"] > 0
        assert "ssm.scan_kernel_steps" not in c
