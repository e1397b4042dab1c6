"""The port's record of a gradient (``core/autodiff.py``) against what
``jax.value_and_grad`` records: the equations of llm_train's step one for
one, small gradient programs written in both frameworks traced to the same
instruction stream, and hazard R5 (a ``split``'s later outputs on pages no
instruction writes) held in the port as in the reference."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch.fx.experimental.proxy_tensor import make_fx  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

from test_torch_vectorize import assert_same_trace  # noqa: E402

from repro.core.vectorize import vectorize as repro_vectorize  # noqa: E402
from repro.workloads import _llama as repro_llama  # noqa: E402
from repro.workloads import llm_train as repro_llm_train  # noqa: E402
from repro_torch.core import autodiff  # noqa: E402
from repro_torch.core import vectorize as vec  # noqa: E402
from repro_torch.workloads import _llama, llm_train  # noqa: E402

try:
    from jax.extend.core import Literal
except ImportError:  # pragma: no cover
    from jax.core import Literal  # type: ignore

RNG = np.random.default_rng(11)
S, D, H, F, V = 8, 64, 2, 128, 96          # seq, width, heads, ffn, vocab
DH = D // H


def _w(*shape):
    return (RNG.standard_normal(shape) * 0.1).astype(np.float32)


LAYER = {"ln1": np.ones(D, np.float32), "ln2": np.ones(D, np.float32),
         "w1": _w(D, F), "w2": _w(F, D), "w3": _w(D, F), "wk": _w(D, D),
         "wo": _w(D, D), "wq": _w(D, D), "wv": _w(D, D)}
X = _w(S, D)
EMB = _w(V, D)
TOKENS = RNG.integers(0, V, size=(S,), dtype=np.int32)
LABELS = RNG.integers(0, V, size=(S,), dtype=np.int32)
ANG = np.arange(S)[:, None] / (100.0 ** (np.arange(DH // 2)[None] / DH))
COS, SIN = np.cos(ANG).astype(np.float32), np.sin(ANG).astype(np.float32)
MASK = np.tril(np.ones((1, S, S), bool))


def _jax_loss(name):
    """``name``'s loss as the JAX package's modules write it."""
    def loss(p, x, tokens, labels, cos, sin, mask):
        if name == "rmsnorm_matmul":
            return jnp.mean(repro_llama.rmsnorm(x @ p["wq"], p["ln1"]))
        if name == "rope":
            q = (x @ p["wq"]).reshape(S, H, DH).transpose(1, 0, 2)
            return jnp.mean(repro_llama.rope(q, cos, sin))
        if name == "attention":
            return jnp.mean(repro_llama.attention(x, p, H, cos, sin, mask))
        if name == "mlp":
            return jnp.mean(repro_llama.mlp(x, p))
        if name == "bias_add":
            return jnp.mean(x + p["ln1"])
        if name == "bias_sub":
            return jnp.mean(x - p["ln1"])
        if name == "embedding_logits":
            h = jnp.take(p["emb"], tokens, axis=0)
            logits = repro_llama.rmsnorm(h, p["ln1"]) @ p["emb"].T
            logz = jax.nn.logsumexp(logits, axis=-1)
            gold = jnp.take_along_axis(logits, labels[:, None], axis=-1)
            return jnp.mean(logz - gold[:, 0])
        raise KeyError(name)
    return loss


def _torch_loss(name):
    def loss(p, x, tokens, labels, cos, sin, mask):
        if name == "rmsnorm_matmul":
            return _llama.rmsnorm(x @ p["wq"], p["ln1"]).mean()
        if name == "rope":
            q = (x @ p["wq"]).reshape(S, H, DH).permute(1, 0, 2)
            return _llama.rope(q, cos, sin).mean()
        if name == "attention":
            return _llama.attention(x, p, H, cos, sin, mask).mean()
        if name == "mlp":
            return _llama.mlp(x, p).mean()
        if name == "bias_add":
            return (x + p["ln1"]).mean()
        if name == "bias_sub":
            return (x - p["ln1"]).mean()
        if name == "embedding_logits":
            h = p["emb"][tokens]
            logits = _llama.rmsnorm(h, p["ln1"]) @ p["emb"].T
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.take_along_dim(logits, labels[:, None], dim=-1)
            return (logz - gold[:, 0]).mean()
        raise KeyError(name)
    return loss


# bias_add and bias_sub: a differentiated operand broadcast inside the op
# beside a constant one (the JVP's _maybe_broadcast; sub's neg)
PROGRAMS = ["rmsnorm_matmul", "rope", "attention", "mlp", "bias_add",
            "bias_sub", "embedding_logits"]


def _inputs(name):
    params = dict(LAYER)
    if name == "embedding_logits":
        params["emb"] = EMB
    params = {k: params[k] for k in sorted(params)}   # jax's leaf order
    return (params, X, TOKENS, LABELS, COS, SIN, MASK)


def both_grads(name, **kw):
    """``name``'s (loss, grads) traced by both tracers."""
    jloss, tloss = _jax_loss(name), _torch_loss(name)

    def jfn(*args):
        return jax.value_and_grad(jloss)(*args)

    def tfn(*args):
        grads, loss = torch.func.grad_and_value(tloss)(*args)
        return loss, grads

    args = _inputs(name)
    want = repro_vectorize(jfn, *jax.tree_util.tree_map(jnp.asarray, args),
                           **kw)
    targs = pytree.tree_map(lambda a: torch.from_numpy(np.array(a)), args)
    targs = targs[:3] + (targs[3].long(),) + targs[4:]
    got = vec.vectorize(tfn, *targs, **kw)
    return got, want


# unquantized, element widths count: the port's labels are int64
# (take_along_dim's index type) and take the reference's int32 lanes
@pytest.mark.parametrize("name,quantize", [
    (name, q) for q in (True, False) for name in PROGRAMS])
def test_gradient_program_matches_repro(name, quantize):
    got, want = both_grads(name, quantize=quantize)
    assert_same_trace(got, want)
    assert got.characterize().as_row() == want.characterize().as_row()


# -- llm_train's equations, one for one --------------------------------------

def _canonical_port(eqns, inputs):
    """(primitive, operand ids, output ids and shapes) of each equation,
    vars numbered in order of first appearance, inputs first."""
    names = {}

    def name(a):
        if isinstance(a, autodiff.Lit):
            return f"lit {float(np.float32(a.value))!r}"
        return f"v{names.setdefault(id(a), len(names))}"

    for v in inputs:
        name(v)
    out = []
    for e in eqns:
        prim = e.prim + (f":{e.params['name']}" if e.prim == "jit" else "")
        out.append((prim, [name(a) for a in e.ins],
                    [(name(a), a.shape) for a in e.outs]))
    return out


def _canonical_jaxpr(jaxpr):
    names = {}

    def name(a):
        if isinstance(a, Literal):
            return f"lit {float(np.float32(a.val))!r}"
        return f"v{names.setdefault(a, len(names))}"

    for v in jaxpr.invars:
        name(v)
    out = []
    for e in jaxpr.eqns:
        prim = e.primitive.name
        if prim == "jit":
            prim += f":{e.params['name']}"
        out.append((prim, [name(a) for a in e.invars],
                    [(name(a), tuple(a.aval.shape)) for a in e.outvars]))
    return out


def recorded_equations(scale):
    """llm_train's gradient region as the port records it."""
    fn = llm_train.make_fn(scale)
    args = llm_train.make_inputs(scale, device="meta")
    with vec._KeepEinsum(), vec._recording_gradients() as regions:
        gm = make_fx(fn, tracing_mode="fake",
                     _allow_non_fake_inputs=True)(*args)
        (func, spec, diff), = regions
    node, = [n for n in gm.graph.nodes
             if getattr(n.target, "__name__", "").startswith(
                 "grad_and_value")]
    metas = [torch.empty(a.meta["val"].shape, dtype=a.meta["val"].dtype,
                         device="meta") for a in node.args[1]]
    with vec._KeepEinsum():
        loss_gm = make_fx(
            lambda *leaves: func(*pytree.tree_unflatten(list(leaves), spec)),
            tracing_mode="fake", _allow_non_fake_inputs=True)(*metas)
    return autodiff.value_and_grad_eqns(loss_gm, diff)


@pytest.mark.parametrize("scale", ["tiny", "paper"])
def test_llm_train_equations_are_the_jaxprs(scale):
    """Every equation of the recorded gradient is the reference jaxpr's,
    in order, operand for operand; the jaxpr's remaining equations are the
    SGD update (a ``mul`` and a ``sub`` for each parameter), which the
    port's outer graph holds."""
    eqns, inputs, outputs = recorded_equations(scale)
    jaxpr = jax.make_jaxpr(repro_llm_train.make_fn(scale))(
        *repro_llm_train.make_inputs(scale)).jaxpr
    got, want = _canonical_port(eqns, inputs), _canonical_jaxpr(jaxpr)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"equation {k}: port {g}, jaxpr {w}"
    n_params = len(outputs) - 1
    assert len(want) == len(got) + 2 * n_params
    assert [e[0] for e in want[len(got):]] == ["mul", "sub"] * n_params


def test_llm_train_primitives_of_the_backward():
    """The transpose rules' primitives that the forward does not have."""
    eqns, _, _ = recorded_equations("tiny")
    prims = [e.prim for e in eqns]
    for prim, count in {"add_any": 21, "pad": 5, "neg": 5, "split": 2,
                        "integer_pow": 1, "is_finite": 1, "sign": 1,
                        "abs": 1, "ge": 1, "log": 1}.items():
        assert prims.count(prim) == count, prim
    jits = [e.params["name"] for e in eqns if e.prim == "jit"]
    assert jits == ["_take", "_where", "silu", "take_along_axis",
                    "take_along_axis", "silu", "_where", "_take"]


# -- hazard R5 ----------------------------------------------------------------

def _split_pages(trace):
    return {pid for pid, e in trace.pages.entries.items()
            if e.name.startswith("split[")}


def test_split_later_outputs_take_pages_nothing_writes():
    """R5: JAX's ``split`` is free; its first output aliases the source's
    pages and each later one takes fresh pages with no instruction, so the
    second half's cotangent reads pages nothing wrote.  rope's
    ``concatenate`` transposes to a ``split``; the port matches."""
    got, want = both_grads("rope")
    assert_same_trace(got, want)
    for trace in (got, want):
        pages = _split_pages(trace)
        assert pages                          # kept: read before written
        assert not any(i.dst in pages for i in trace.instrs)
        assert any(set(i.srcs) & pages for i in trace.instrs)
    assert _split_pages(got) == _split_pages(want)


def test_split_equation_lowers_as_free():
    """One ``split`` equation through the port's lowering: the first
    output aliases, the second gets fresh pages and no instruction."""
    v = vec._Vectorizer(vec.DEFAULT_SSD, 1, True, 1000)
    src = autodiff.Var((4, 16384), torch.float32)
    a, b = autodiff.Var((2, 16384), torch.float32), autodiff.Var(
        (2, 16384), torch.float32)
    env = {src: v.pages.alloc_array(4 * 16384, "in0")}
    v.eqn(autodiff.Eqn("split", [src], [a, b], {"axis": 0}), env)
    assert env[a] == env[src][:2]
    assert not set(env[b]) & set(env[src]) and len(env[b]) == 2
    assert v.instrs == []


# -- the capture --------------------------------------------------------------

def test_grad_and_value_node_exists_only_in_a_capture():
    with pytest.raises(RuntimeError, match="only while vectorize"):
        vec._grad_and_value_node(0, [torch.zeros(2)])


def test_capture_restores_grad_and_value():
    real = torch.func.grad_and_value
    with pytest.raises(RuntimeError):
        with vec._recording_gradients():
            assert torch.func.grad_and_value is not real
            raise RuntimeError("stop")
    assert torch.func.grad_and_value is real
    vec.vectorize(lambda x: x + 1, torch.zeros(4))
    assert torch.func.grad_and_value is real


def test_an_op_without_a_rule_is_named():
    def loss(x):
        return torch.cumsum(x, 0).sum()

    def fn(x):
        g, v = torch.func.grad_and_value(loss)(x)
        return v, g

    with pytest.raises(NotImplementedError, match="cumsum"):
        vec.vectorize(fn, torch.zeros(8))


def test_numbers_stay_torch_autograds():
    """The traced program still computes torch's gradient: the capture
    changes the record, not the values."""
    loss_fn = _torch_loss("attention")
    args = pytree.tree_map(lambda a: torch.from_numpy(np.array(a)),
                           _inputs("attention"))
    grads, loss = torch.func.grad_and_value(loss_fn)(*args)
    wgrads, wloss = jax.value_and_grad(_jax_loss("attention"))(
        *jax.tree_util.tree_map(jnp.asarray, _inputs("attention")))[::-1]
    assert math.isclose(float(loss), float(wloss), abs_tol=1e-6)
    for g, w in zip(pytree.tree_leaves(grads),
                    jax.tree_util.tree_leaves(wgrads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
