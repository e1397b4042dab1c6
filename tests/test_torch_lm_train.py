"""The port's LM training path against the JAX package's: schedules, AdamW,
INT8 gradient compression, the synthetic data pipeline, checkpoints,
elasticity, ``lm_loss`` and its gradients, the train step and the training
driver, on the CPU.

Tolerances: the schedules within 1 float32 ulp of the base rate; AdamW
within 1e-6 in fp32; ``lm_loss`` and every parameter gradient within 1e-5
(absolute and relative) in fp32, where the two autodiff frameworks sum in
other orders; the train step within ``chip_smoke.TRAIN_TOL``.  In bf16
the loss is held within 2e-2 and each gradient within 5 % of its norm:
both packages round every activation to bf16, but at other points of
their summation orders.
"""
import dataclasses
import os
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from _lm_reference import jax_config, jax_params  # noqa: E402
from repro import checkpoint as repro_checkpoint  # noqa: E402
from repro import optim as repro_optim  # noqa: E402
from repro.data import SyntheticLM as RefSyntheticLM  # noqa: E402
from repro.launch.steps import build_train_step as ref_train_step  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.optim import adamw as repro_adamw  # noqa: E402
from repro.optim import compress as repro_compress  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                    load_checkpoint, save_checkpoint)
from repro_torch.data import SyntheticLM, batch_for_step  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.elastic import (SimulatedFailure,  # noqa: E402
                                        StragglerMonitor, run_elastic)
from repro_torch.launch.steps import (build_train_step,  # noqa: E402
                                      loss_and_grads)
from repro_torch.launch.train import (device_batch,  # noqa: E402
                                      state_from_numpy, train)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim.compress import init_residuals  # noqa: E402

ARCH = "tinyllama-1.1b"


@pytest.fixture(autouse=True)
def one_thread():
    """Each test's torch ops on one thread: at these sizes threads do not
    pay, and beside other test processes on the same cores a team of
    OpenMP threads per process slows a bf16 training run many times
    over.  The process's setting is restored after the test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_config(dtype="float32", **kw):
    return dataclasses.replace(configs.get(ARCH).reduced(), dtype=dtype,
                               **kw)


# -- schedules ----------------------------------------------------------------

@pytest.mark.parametrize("kind,total,warmup", [
    ("cosine", 200, None), ("wsd", 200, None), ("cosine", 1000, 37),
    ("wsd", 30, 5)])
def test_schedules_equal_jax_within_one_ulp(kind, total, warmup):
    """Every step within 1 float32 ulp of the base rate; wsd within 1 ulp
    of its own value.  The cosine's ``1 + cos(pi t)`` cancels near t = 1,
    and torch's and XLA's float32 cos differ in the last bit (neither is
    correctly rounded), so there its value moves by a few of its own ulp,
    a few hundredths of the base rate's."""
    base_lr = np.float32(3e-4)
    mine = optim.make_schedule(kind, float(base_lr), total, warmup)
    ref = repro_optim.make_schedule(kind, float(base_lr), total, warmup)
    steps = range(total + 5)
    got = np.array([float(mine(s)) for s in steps], np.float32)
    want = np.array([np.asarray(ref(s)) for s in steps], np.float32)
    assert np.abs(got - want).max() <= np.spacing(base_lr)
    if kind == "wsd":
        np.testing.assert_array_max_ulp(got, want, maxulp=1)
    # a tensor step gives the same numbers
    assert float(mine(torch.tensor(7, dtype=torch.int32))) == got[7]


def test_wsd_schedule_phases():
    lr = lambda s: float(optim.wsd_schedule(s, 1.0, warmup=10,  # noqa: E731
                                            stable=80, decay=10))
    assert lr(0) == pytest.approx(0.1)
    assert lr(4) == pytest.approx(0.5)
    assert lr(50) == pytest.approx(1.0)
    assert lr(95) < 1.0
    assert lr(100) == pytest.approx(0.1)
    cos = optim.make_schedule("cosine", 1.0, 100)
    assert float(cos(100)) == pytest.approx(0.1, abs=0.02)


# -- AdamW --------------------------------------------------------------------

def _random_tree(rng, scale):
    shapes = {"a": (3, 4), "b": {"c": (5,), "d": (2, 2)}, "e": [(6,), (1, 3)]}
    return jax.tree_util.tree_map(
        lambda s: (rng.normal(size=s) * scale).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [0.05, 10.0],
                         ids=["unclipped", "clipped"])
def test_adamw_update_equals_jax(grad_scale, dtype):
    """Two steps (the second exercises the bias corrections) on a random
    tree; with the clipped gradients the global norm exceeds 1.  fp32
    parameters and the moments within 1e-6; bf16 parameters within one
    bf16 ulp, since the fp32 results round to bf16 in both."""
    rng = np.random.default_rng(0)
    params = _random_tree(rng, 1.0)
    grads = [_random_tree(rng, grad_scale) for _ in range(2)]
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    p_j = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), params)
    p_t = pytree.tree_map(lambda a: _t(a).to(tdt), params)
    s_j, s_t = repro_optim.adamw_init(p_j), optim.adamw_init(p_t)
    for g in grads:
        p_j, s_j, m_j = repro_optim.adamw_update(
            p_j, jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), g),
            s_j, lr=jnp.float32(1e-2))
        p_t, s_t, m_t = optim.adamw_update(
            p_t, pytree.tree_map(lambda a: _t(a).to(tdt), g), s_t,
            lr=torch.tensor(1e-2))
        assert (float(m_t["grad_norm"]) > 1.0) == (grad_scale > 1.0)
        np.testing.assert_allclose(float(m_t["grad_norm"]),
                                   float(m_j["grad_norm"]), rtol=1e-6)
    assert int(s_t.step) == int(s_j.step) == 2
    assert s_t.step.dtype == torch.int32
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    for got, want in zip(pytree.tree_leaves(p_t),
                         jax.tree_util.tree_leaves(p_j)):
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)
    for tree_t, tree_j in ((s_t.mu, s_j.mu), (s_t.nu, s_j.nu)):
        for got, want in zip(pytree.tree_leaves(tree_t),
                             jax.tree_util.tree_leaves(tree_j)):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-6, rtol=1e-6)


def test_adamw_is_functional():
    params = {"w": torch.ones(3)}
    state = optim.adamw_init(params)
    new, new_state, _ = optim.adamw_update(params, {"w": torch.ones(3)},
                                           state, lr=0.1)
    assert torch.equal(params["w"], torch.ones(3))
    assert int(state.step) == 0 and torch.equal(state.mu["w"],
                                                torch.zeros(3))
    assert not torch.equal(new["w"], params["w"])
    assert int(new_state.step) == 1


def test_adamw_matches_moments_by_key_whatever_the_dict_order():
    params = {"x": torch.zeros(2), "y": torch.zeros(3)}
    state = optim.adamw_init(params)
    state = state._replace(mu={"y": state.mu["y"], "x": state.mu["x"]})
    grads = {"y": torch.ones(3), "x": torch.ones(2)}
    new, _, _ = optim.adamw_update(params, grads, state, lr=0.1)
    assert new["x"].shape == (2,) and new["y"].shape == (3,)


def test_adamw_optimizes_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = optim.adamw_init(params)
    for _ in range(200):
        w = params["w"].clone().requires_grad_()
        (g,) = torch.autograd.grad(torch.sum(w ** 2), [w])
        params, state, _ = optim.adamw_update(params, {"w": g}, state,
                                              lr=0.05, weight_decay=0.0)
    assert float(params["w"].abs().max()) < 0.3
    assert int(state.step) == 200


def test_grad_clipping_bounds_update():
    params = {"w": torch.zeros(4)}
    state = optim.adamw_init(params)
    new, _, m = optim.adamw_update(params, {"w": torch.full((4,), 1e9)},
                                   state, lr=0.1, clip_norm=1.0,
                                   weight_decay=0.0)
    assert float(m["grad_norm"]) > 1e8
    assert float(new["w"].abs().max()) < 1.0


# -- INT8 compression ---------------------------------------------------------

@pytest.mark.parametrize("scale", [1.0, 1e-3, 0.0])
def test_compress_int8_equals_jax(scale):
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(257,)) * scale).astype(np.float32)
    x[:3] = [0.5, -0.5, 1.5]            # ties round half to even in both
    q_t, s_t = optim.compress_int8(_t(x))
    q_j, s_j = repro_optim.compress_int8(jnp.asarray(x))
    assert q_t.dtype == torch.int8
    assert np.array_equal(q_t.numpy(), np.asarray(q_j))
    assert float(s_t) == float(s_j)
    assert np.array_equal(optim.decompress_int8(q_t, s_t).numpy(),
                          np.asarray(repro_optim.decompress_int8(q_j, s_j)))


def test_int8_compression_roundtrip_error():
    rng = np.random.default_rng(0)
    x = _t(rng.normal(size=(256,)))
    q, s = optim.compress_int8(x)
    err = (optim.decompress_int8(q, s) - x).abs()
    assert float(err.max()) <= float(s) / 2 + 1e-6


def test_error_feedback_is_unbiased_over_steps_and_equals_jax():
    rng = np.random.default_rng(1)
    g_true = rng.normal(size=(64,)).astype(np.float32) * 1e-3
    grads_t, grads_j = {"w": _t(g_true)}, {"w": jnp.asarray(g_true)}
    res_t = init_residuals(grads_t)
    res_j = repro_compress.init_residuals(grads_j)
    acc = np.zeros(64)
    steps = 50
    for _ in range(steps):
        deq, res_t = optim.error_feedback_update(grads_t, res_t)
        deq_j, res_j = repro_optim.error_feedback_update(grads_j, res_j)
        np.testing.assert_allclose(deq["w"].numpy(), np.asarray(deq_j["w"]),
                                   atol=1e-9)
        acc += deq["w"].numpy()
    total_err = np.abs(acc - steps * g_true).max()
    assert total_err <= float(np.abs(g_true).max()) * 2 + 1e-4


# -- data ---------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seq,batch,seed", [(128, 16, 8, 7),
                                                  (32000, 64, 4, 0)])
def test_synthetic_batches_and_shards_bit_equal_jax(vocab, seq, batch, seed):
    mine = SyntheticLM(vocab, seq, batch, seed=seed)
    ref = RefSyntheticLM(vocab, seq, batch, seed=seed)
    for step in (0, 3, 11):
        got, want = mine.batch(step), ref.batch(step)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype == np.int32
            assert np.array_equal(got[k], want[k])
        for shard in range(batch // 2):
            part = mine.shard_for(step, shard, batch // 2)
            assert all(np.array_equal(part[k], ref.shard_for(
                step, shard, batch // 2)[k]) for k in part)
    assert np.array_equal(batch_for_step(vocab, seq, batch, 5)["tokens"],
                          RefSyntheticLM(vocab, seq, batch).batch(5)[
                              "tokens"])
    b = mine.batch(3)
    assert np.array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


# -- checkpoints --------------------------------------------------------------

def _tree_np():
    return {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": {"c": np.linspace(-2, 2, 4).astype(np.float32),
                  "s": np.asarray(3, np.int32)},
            "l": [np.ones((2,), np.float32), None]}


def _tree_jax(tree):
    out = jax.tree_util.tree_map(jnp.asarray, tree)
    out["b"]["c"] = out["b"]["c"].astype(jnp.bfloat16)
    return out


def _tensors(tree):
    return [x for x in pytree.tree_leaves(tree) if x is not None]


def _tree_torch(tree, leaf=torch.from_numpy):
    """``tree`` with tensor leaves (``None`` stays: torch's pytree would
    take it for a leaf)."""
    out = {"a": leaf(tree["a"]),
           "b": {"c": leaf(tree["b"]["c"]).to(torch.bfloat16),
                 "s": leaf(tree["b"]["s"])},
           "l": [leaf(tree["l"][0]), None]}
    return out


def test_jax_written_checkpoint_restores_in_the_port(tmp_path):
    """fp32, bf16 and int32 leaves; the manifest's treedef is the JAX
    package's string for the same tree."""
    tree = _tree_np()
    repro_checkpoint.save_checkpoint(str(tmp_path), 7, _tree_jax(tree),
                                     extra={"note": "x"})
    template = _tree_torch(tree, lambda a: torch.zeros(a.shape, dtype=(
        torch.from_numpy(a).dtype)))
    restored, manifest = load_checkpoint(str(tmp_path), template)
    assert manifest["step"] == 7 and manifest["extra"] == {"note": "x"}
    want = _tree_torch(tree)
    assert restored["b"]["c"].dtype == torch.bfloat16
    assert restored["b"]["s"].dtype == torch.int32
    assert restored["l"][1] is None
    for got, exp in zip(_tensors(restored), _tensors(want)):
        assert got.dtype == exp.dtype and torch.equal(got, exp)
    d2 = tmp_path / "port"
    save_checkpoint(str(d2), 7, want, extra={"note": "x"})
    with open(d2 / "step_000000007" / "manifest.json") as f:
        mine = f.read()
    with open(tmp_path / "step_000000007" / "manifest.json") as f:
        theirs = f.read()
    assert mine == theirs        # treedef, shapes, dtypes and hash


def test_port_checkpoint_round_trip_and_jax_restore(tmp_path):
    tree = _tree_torch(_tree_np())
    save_checkpoint(str(tmp_path), 3, tree)
    restored, manifest = load_checkpoint(str(tmp_path), tree)
    assert manifest["step"] == 3
    assert all(torch.equal(a, b) and a.dtype == b.dtype for a, b in zip(
        _tensors(restored), _tensors(tree)))
    # the JAX package reads the port's checkpoint
    theirs, _ = repro_checkpoint.load_checkpoint(str(tmp_path),
                                                 _tree_jax(_tree_np()))
    assert np.array_equal(np.asarray(theirs["b"]["c"], np.float32),
                          tree["b"]["c"].float().numpy())


def test_checkpoint_of_the_train_state_restores_on_its_template(tmp_path):
    cfg = _port_config("bfloat16")
    gen = torch.Generator().manual_seed(0)
    params = M.init_params(cfg, gen)
    state = {"params": params, "opt": optim.adamw_init(params)}
    state["opt"] = state["opt"]._replace(step=state["opt"].step + 5)
    save_checkpoint(str(tmp_path), 5, state)
    template = {"params": M.init_params(cfg, gen),
                "opt": optim.adamw_init(params)}
    restored, _ = load_checkpoint(str(tmp_path), template)
    assert isinstance(restored["opt"], optim.AdamWState)
    assert int(restored["opt"].step) == 5
    assert list(restored["params"]) == list(params)
    for got, want in zip(pytree.tree_leaves(restored),
                         pytree.tree_leaves(state)):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_checkpoint_corruption_and_shape_are_detected(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.float32)}
    d = str(tmp_path)
    save_checkpoint(d, 1, tree)
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(d, {"w": torch.zeros(5)})
    with pytest.raises(ValueError, match="leaves"):
        load_checkpoint(d, {"w": torch.zeros(6), "v": torch.zeros(1)})
    npz = os.path.join(d, "step_000000001", "arrays.npz")
    data = dict(np.load(npz, allow_pickle=False))
    data["leaf_0"] = data["leaf_0"] + 1
    np.savez(npz, **data)
    with pytest.raises(IOError):
        load_checkpoint(d, tree)


def test_checkpoint_manager_async_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    assert mgr.latest_step() is None
    tree = {"w": torch.zeros(3)}
    for s in (1, 2, 3, 4):
        mgr.save(s, {"w": tree["w"] + s})
    mgr.wait()
    steps = sorted(x for x in os.listdir(tmp_path) if x.startswith("step_"))
    assert steps == ["step_000000003", "step_000000004"]
    assert mgr.latest_step() == 4
    restored, _ = mgr.restore(tree)
    assert torch.equal(restored["w"], torch.full((3,), 4.0))
    restored, _ = mgr.restore(tree, step=3)
    assert torch.equal(restored["w"], torch.full((3,), 3.0))


# -- elasticity ---------------------------------------------------------------

def test_straggler_monitor():
    mon = StragglerMonitor(threshold=2.0, min_samples=3)
    for _ in range(5):
        assert not mon.observe(1.0)
    assert mon.observe(5.0)
    assert mon.flagged == 1
    assert not mon.observe(1.1)
    assert mon.rescale_factor(16, 1) == pytest.approx(16 / 15)


def test_run_elastic_restarts():
    calls = {"n": 0}

    def fn(resume):
        calls["n"] += 1
        if calls["n"] < 3:
            raise SimulatedFailure("boom")
        return 42

    seen = []
    assert run_elastic(fn, max_restarts=5,
                       on_restart=lambda n, e: seen.append(n)) == 42
    assert calls["n"] == 3 and seen == [1, 2]
    calls["n"] = 0
    with pytest.raises(SimulatedFailure):
        run_elastic(fn, max_restarts=1)


# -- K6 refuses autograd; training takes the einsum path ----------------------

def test_flash_attention_raises_under_autograd():
    q, k, v = (torch.randn(2, 8, 16) for _ in range(3))
    ops.flash_attention(q, k, v)                       # no grad: fine
    for i in range(3):
        args = [q, k, v]
        args[i] = args[i].clone().requires_grad_()
        with pytest.raises(RuntimeError, match="no backward"):
            ops.flash_attention(*args)
        with torch.no_grad():
            ops.flash_attention(*args)


def test_forward_through_the_kernel_refuses_autograd():
    """The serving path's attention does not quietly lose the gradient of
    wq, wk and wv: under autograd it raises."""
    cfg = _port_config()
    p = M.params_from_numpy(cfg, jax_params(ARCH), "cpu")
    p["layers"][0]["attn"]["wq"].requires_grad_()
    tok = torch.zeros((1, 4), dtype=torch.int64)
    x = M.embed(cfg, p, tok)
    with pytest.raises(RuntimeError, match="no backward"):
        M.forward(cfg, p, x, torch.arange(4).expand(1, 4))


def test_lm_loss_attends_through_the_einsum_path(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("lm_loss called flash_attention")

    monkeypatch.setattr(ops, "flash_attention", refuse)
    cfg = _port_config()
    p = M.params_from_numpy(cfg, jax_params(ARCH), "cpu")
    tok = torch.zeros((1, 4), dtype=torch.int64)
    loss, grads = loss_and_grads(cfg, p, {"tokens": tok, "labels": tok})
    assert torch.isfinite(loss)
    assert float(grads["layers"][0]["attn"]["wq"].norm()) > 0


@pytest.mark.parametrize("sq", [16, 1024, 1000])
def test_chunked_einsum_attention_equals_one_block(sq):
    """The q-block loop runs at a multiple of SDPA_CHUNK above it and
    equals the unchunked product; other lengths take one block."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, sq, 2, 16, generator=g) for _ in range(3))
    got = L._sdpa(q, k, v, causal=True, flash=False)
    want = L._sdpa_block(q, k, v, True, 0)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(
        got, L._sdpa(q, k, v, causal=True, flash=True), atol=1e-5,
        rtol=1e-5)


# -- lm_loss and its gradients against jax.value_and_grad ---------------------

@pytest.fixture(scope="module")
def jax_loss_and_grads():
    """jax.value_and_grad of the JAX package's lm_loss, compiled once per
    (remat, batch, seq, dtype)."""
    cache = {}

    def get(remat, batch, seq, dtype):
        key = (remat, batch, seq, dtype)
        if key not in cache:
            cfg = dataclasses.replace(jax_config(ARCH, dtype), remat=remat)
            rng = np.random.default_rng(seq)
            tok = rng.integers(0, cfg.vocab, (batch, seq), dtype=np.int32)
            lab = rng.integers(0, cfg.vocab, (batch, seq), dtype=np.int32)
            params = jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.dtype(dtype)), jax_params(ARCH))
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p, t, lb: RM.lm_loss(cfg, p, t, lb)))(
                    params, jnp.asarray(tok), jnp.asarray(lab))
            cache[key] = (float(loss), _np(jax.tree_util.tree_map(
                lambda g: g.astype(jnp.float32), grads)), tok, lab)
        return cache[key]
    return get


def _port_loss_and_grads(remat, dtype, tok, lab):
    cfg = _port_config(dtype, remat=remat)
    p = M.params_from_numpy(cfg, jax_params(ARCH), "cpu")
    loss, grads = loss_and_grads(cfg, p, {
        "tokens": torch.from_numpy(tok).long(),
        "labels": torch.from_numpy(lab).long()})
    return cfg, float(loss), grads


@pytest.mark.parametrize("batch,seq", [(2, 16), (1, 1024)])
@pytest.mark.parametrize("remat", [False, True])
def test_lm_loss_and_every_gradient_equal_jax(jax_loss_and_grads, remat,
                                              batch, seq):
    """fp32, with remat on and off; at seq 1024 the einsum path's q-block
    loop runs (two blocks of SDPA_CHUNK)."""
    loss_j, grads_j, tok, lab = jax_loss_and_grads(remat, batch, seq,
                                                   "float32")
    cfg, loss_t, grads_t = _port_loss_and_grads(remat, "float32", tok, lab)
    assert abs(loss_t - loss_j) <= 1e-5
    want = M.params_from_numpy(cfg, grads_j, "cpu")
    n = 0
    for got, exp in zip(pytree.tree_leaves(grads_t),
                        pytree.tree_leaves(want)):
        assert got.dtype == torch.float32 and got.shape == exp.shape
        torch.testing.assert_close(got, exp, atol=1e-5, rtol=1e-5)
        n += 1
    assert n == 3 + 9 * cfg.n_layers


def test_lm_loss_and_gradients_in_bf16_near_jax(jax_loss_and_grads):
    loss_j, grads_j, tok, lab = jax_loss_and_grads(False, 2, 16,
                                                   "bfloat16")
    cfg, loss_t, grads_t = _port_loss_and_grads(False, "bfloat16", tok, lab)
    assert abs(loss_t - loss_j) <= 2e-2
    want = M.params_from_numpy(cfg, grads_j, "cpu", torch.float32)
    for got, exp in zip(pytree.tree_leaves(grads_t),
                        pytree.tree_leaves(want)):
        assert got.dtype == torch.bfloat16
        err = float((got.float() - exp).norm())
        assert err <= 5e-2 * float(exp.norm()), err


# -- the train step -----------------------------------------------------------

@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_equal_the_jax_packages(microbatches):
    """Three steps from the JAX init with zero AdamW state: each step's
    metrics within TRAIN_TOL, and every parameter and moment within 1e-5,
    after the state of the first step is carried across from JAX."""
    cfg_j, cfg_t = jax_config(ARCH), _port_config()
    tree = jax_params(ARCH)
    step_j = jax.jit(ref_train_step(cfg_j, total_steps=3, base_lr=1e-3,
                                    microbatches=microbatches))
    step_t = build_train_step(cfg_t, total_steps=3, base_lr=1e-3,
                              microbatches=microbatches)
    data = SyntheticLM(cfg_t.vocab, 32, 4, seed=0)
    p_j = jax.tree_util.tree_map(jnp.asarray, tree)
    o_j = repro_optim.adamw_init(p_j)
    zeros = jax.tree_util.tree_map(np.zeros_like, tree)
    state = state_from_numpy(cfg_t, tree,
                             repro_adamw.AdamWState(np.int32(0), zeros,
                                                    zeros), "cpu")
    p_t, o_t = state["params"], state["opt"]
    for step in range(3):
        batch = data.batch(step)
        new_j, o_j, m_j = step_j(p_j, o_j, {k: jnp.asarray(v)
                                             for k, v in batch.items()})
        new_t, o_t, m_t = step_t(p_t, o_t, device_batch(batch,
                                                                 "cpu"))
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
        p_j, p_t = new_j, new_t
        if step == 0:
            # carry JAX's state after one step across; go on from there
            state = state_from_numpy(cfg_t, _np(p_j), _np(o_j), "cpu")
            p_t, o_t = state["params"], state["opt"]
            assert int(o_t.step) == 1
    for mine, theirs in ((p_t, p_j), (o_t.mu, o_j.mu), (o_t.nu, o_j.nu)):
        want = M.params_from_numpy(cfg_t, _np(theirs), "cpu")
        for a, b in zip(pytree.tree_leaves(mine), pytree.tree_leaves(want)):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_microbatched_step_matches_full_batch():
    cfg = _port_config()
    p = M.params_from_numpy(cfg, jax_params(ARCH), "cpu")
    batch = device_batch(SyntheticLM(cfg.vocab, 16, 8, seed=1)
                                 .batch(0), "cpu")
    full = build_train_step(cfg, 10)(p, optim.adamw_init(p), batch)
    micro = build_train_step(cfg, 10, microbatches=4)(
        p, optim.adamw_init(p), batch)
    assert float(full[2]["loss"]) == pytest.approx(float(micro[2]["loss"]),
                                                   rel=1e-5)
    for a, b in zip(pytree.tree_leaves(full[0]),
                    pytree.tree_leaves(micro[0])):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="microbatches"):
        build_train_step(cfg, 10, microbatches=3)(p, optim.adamw_init(p),
                                                  batch)


def test_state_from_numpy_takes_the_jax_train_state():
    cfg = _port_config("bfloat16")
    tree = jax_params(ARCH)
    mu = jax.tree_util.tree_map(lambda a: np.full_like(a, 0.5), tree)
    nu = jax.tree_util.tree_map(lambda a: np.full_like(a, 0.25), tree)
    state = state_from_numpy(cfg, tree,
                             repro_adamw.AdamWState(np.int32(9), mu, nu),
                             "cpu")
    assert int(state["opt"].step) == 9
    assert state["opt"].step.dtype == torch.int32
    assert state["params"]["emb"].dtype == torch.bfloat16
    assert len(state["params"]["layers"]) == cfg.n_layers
    for leaf in pytree.tree_leaves(state["opt"].mu):
        assert leaf.dtype == torch.float32 and bool((leaf == 0.5).all())
    assert pytree.tree_structure(state["opt"].nu) == pytree.tree_structure(
        state["params"])


# -- the training driver ------------------------------------------------------

def test_train_loss_decreases():
    res = train(ARCH, steps=40, batch=8, seq=32, ckpt_dir=None,
                reduced=True, base_lr=3e-3, log_every=100, device="cpu")
    assert len(res["losses"]) == 40
    assert res["final_loss"] < res["first_loss"] * 0.8


def test_restart_is_bit_equal_to_the_straight_run(tmp_path, capsys):
    """train 8 straight against train 8 with a crash at 5 and a resume:
    the checkpointed state and the stateless stream replay exactly."""
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    kw = dict(steps=8, batch=4, seq=16, ckpt_every=2, reduced=True,
              log_every=1, device="cpu")
    full = train(ARCH, ckpt_dir=d1, **kw)
    with pytest.raises(SimulatedFailure):
        train(ARCH, ckpt_dir=d2, fail_at=5, **kw)
    resumed = train(ARCH, ckpt_dir=d2, **kw)
    out = capsys.readouterr().out
    assert "[train] resumed from checkpoint step 4" in out
    assert "[train] step     7 loss" in out
    assert resumed["final_loss"] == full["final_loss"]
    assert resumed["losses"] == full["losses"][4:]
    for a, b in zip(pytree.tree_leaves(full["state"]),
                    pytree.tree_leaves(resumed["state"])):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_train_phase_rehearsed_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke's train phase at the pinned size: the JAX package's
    metrics, the restart under run_elastic, and the full-width plumbing
    on the reduced config with remat (its step-0 gradient report), at one
    sequence of TRAIN_FULL's length."""
    monkeypatch.setitem(chip_smoke.TRAIN_FULL, "batch", 1)
    for microbatches, want in chip_smoke.TRAIN_LM_REFERENCE.items():
        got = chip_smoke.train_pinned("cpu", microbatches)
        assert all(chip_smoke.train_metrics_within(g, w)
                   for g, w in zip(got, want))
    straight, resumed, attempts = chip_smoke.train_restart("cpu",
                                                           str(tmp_path))
    assert attempts == 2
    assert straight["final_loss"] == resumed["final_loss"]
    assert chip_smoke.largest_difference(straight["state"],
                                         resumed["state"]) == 0.0
    assert chip_smoke.configs.get is configs.get
    cfg = _port_config("bfloat16", remat=True)
    res = chip_smoke.train_full(cfg, "cpu")
    assert len(res["gradients"]) == 3 + 9 * cfg.n_layers
    assert all(f and n > 0 for f, n in res["gradients"].values())
    assert len(res["losses"]) == chip_smoke.TRAIN_FULL["steps"]
    assert res["n_params"] == sum(
        t.numel() for t in pytree.tree_leaves(M.init_params(
            cfg, torch.Generator().manual_seed(0))))
