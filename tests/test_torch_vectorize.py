"""The port's tracer (``make_fx`` ATen walk) against the JAX package's
jaxpr walk: the same program, written once in each framework and fed the
same numpy inputs, gives the same post-``_compact`` instruction stream and
page table."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.vectorize import vectorize as repro_vectorize  # noqa: E402
from repro.workloads import get_trace as repro_get_trace  # noqa: E402
from repro_torch.core.trace import TraceBudgetExceeded  # noqa: E402
from repro_torch.core.vectorize import vectorize  # noqa: E402
from repro_torch.workloads import get_trace  # noqa: E402

RNG = np.random.default_rng(7)
A = RNG.integers(-64, 64, size=(40000,), dtype=np.int32)   # 2.4 pages
B = RNG.integers(-64, 64, size=(40000,), dtype=np.int32)
X = RNG.integers(-64, 64, size=(8, 8192), dtype=np.int32)  # 4 pages
C = RNG.integers(-64, 64, size=(20000,), dtype=np.int32)   # captured
J_C, T_C = jnp.asarray(C), torch.from_numpy(C.copy())

# name -> (jax program, torch program, inputs)
PROGRAMS = {
    "add": (lambda a, b: a + b, lambda a, b: a + b, (A, B)),
    "mul_scalar": (lambda a, b: a * 3, lambda a, b: a * 3, (A, B)),
    "xor": (lambda a, b: a ^ b, lambda a, b: a ^ b, (A, B)),
    "shift_right": (lambda a, b: a >> 3, lambda a, b: a >> 3, (A, B)),
    "shift_left": (lambda a, b: a << 2, lambda a, b: a << 2, (A, B)),
    "gt": (lambda a, b: a > b, lambda a, b: a > b, (A, B)),
    "maximum": (jnp.maximum, torch.maximum, (A, B)),
    "slice_1d": (lambda a, b: a[5:-7] + 1, lambda a, b: a[5:-7] + 1, (A, B)),
    "slice_1d_tail": (lambda a, b: a[-20000:] * 2,
                      lambda a, b: a[-20000:] * 2, (A, B)),
    "slice_2d": (lambda x: x[2:5, 100:3000] * 2,
                 lambda x: x[2:5, 100:3000] * 2, (X,)),
    "slice_2d_cols": (lambda x: x[:, 9000:] + 1,
                      lambda x: x[:, 9000:] + 1, (X,)),
    # rows start mid-page, so aliasing dim by dim would lose the last page
    "slice_2d_reduce": (lambda x: jnp.sum(x[1:7, :10]),
                        lambda x: x[1:7, :10].sum(), (X,)),
    "concat": (lambda a, b: jnp.concatenate([a, b]),
               lambda a, b: torch.cat([a, b]), (A, B)),
    "reduce_sum": (lambda a, b: jnp.sum(a), lambda a, b: a.sum(), (A, B)),
    "reshape": (lambda a, b: a.reshape(4, -1) + 1,
                lambda a, b: a.reshape(4, -1) + 1, (A, B)),
    "transpose": (lambda x: x.T, lambda x: x.T, (X,)),
    "captured_constant": (lambda a, b: a[:20000] + J_C,
                          lambda a, b: a[:20000] + T_C, (A, B)),
}


def stream(trace):
    return [(i.op, i.vlen, i.elem_bytes, i.srcs, i.dst, i.deps,
             i.vectorizable) for i in trace.instrs]


def page_table(trace):
    return [(pid, e.location.name, e.owner.name, e.dirty, e.version,
             e.flash_block, e.channel, e.die, e.name, e.l2p_cached)
            for pid, e in trace.pages.entries.items()]


def both(name, **kw):
    jfn, tfn, inputs = PROGRAMS[name]
    want = repro_vectorize(jfn, *[jnp.asarray(x) for x in inputs], **kw)
    got = vectorize(tfn, *[torch.from_numpy(x.copy()) for x in inputs], **kw)
    return got, want


def assert_same_trace(got, want):
    assert stream(got) == stream(want)
    assert page_table(got) == page_table(want)
    assert got.input_pages == want.input_pages
    assert got.output_pages == want.output_pages


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_one_primitive_program_matches_repro(name):
    got, want = both(name)
    assert_same_trace(got, want)


@pytest.mark.parametrize("name", ["add", "reduce_sum", "slice_2d"])
def test_unquantized_matches_repro(name):
    got, want = both(name, quantize=False)
    assert_same_trace(got, want)


@pytest.mark.parametrize("scale", ["tiny", "paper"])
def test_jacobi1d_trace_matches_repro(scale):
    got = get_trace("jacobi1d", scale, device="cpu")
    want = repro_get_trace("jacobi1d", scale)
    assert_same_trace(got, want)
    assert got.characterize().as_row() == want.characterize().as_row()
    assert (dataclasses.asdict(got.characterize())
            == dataclasses.asdict(want.characterize()))


def test_where_is_select_in_the_port_and_control_in_repro():
    """Pinned known difference (ROADMAP R2): in jax 0.9 ``jnp.where`` is a
    nested ``jit`` the reference walk does not enter, so it emits CONTROL
    ``scalar`` instructions; the port lowers ``aten.where`` to ``select``,
    as the paper means it, with ``select_n``'s operand order."""
    args = (A, B)
    want = repro_vectorize(lambda a, b: jnp.where(a > 0, a, b),
                           *[jnp.asarray(x) for x in args])
    got = vectorize(lambda a, b: torch.where(a > 0, a, b),
                    *[torch.from_numpy(x.copy()) for x in args])
    assert [i.op for i in want.instrs] == ["cmp"] * 3 + ["scalar"] * 3
    assert [i.op for i in got.instrs] == ["cmp"] * 3 + ["select"] * 3
    assert [i.vectorizable for i in want.instrs] == [True] * 3 + [False] * 3
    assert all(i.vectorizable for i in got.instrs)
    for g, w in zip(got.instrs[3:], want.instrs[3:]):
        c, x, y = w.srcs                       # CONTROL keeps (c, x, y)
        assert g.srcs == (c, y, x)             # select_n(c, y, x)
        assert (g.vlen, g.dst, g.deps) == (w.vlen, w.dst, w.deps)
    assert stream(got)[:3] == stream(want)[:3]
    names = [e.name for e in got.pages.entries.values()]
    assert names == [e.name.replace("jit", "select_n")
                     for e in want.pages.entries.values()]


def test_unknown_op_takes_the_control_fallback():
    """cumsum is CONTROL on both sides; the reference names its pages after
    the nested ``jit`` it does not enter (R2), the port after the op."""
    want = repro_vectorize(lambda a, b: jnp.cumsum(a),
                           jnp.asarray(A), jnp.asarray(B))
    got = vectorize(lambda a, b: torch.cumsum(a, 0),
                    torch.from_numpy(A.copy()), torch.from_numpy(B.copy()))
    assert stream(got) == stream(want)
    assert {i.op for i in got.instrs} == {"scalar"}
    assert not any(i.vectorizable for i in got.instrs)
    assert [e.name for e in got.pages.entries.values()] == [
        e.name.replace("jit", "cumsum") for e in want.pages.entries.values()]


def test_budget_exceeded_raises():
    with pytest.raises(TraceBudgetExceeded, match="max_instrs=2"):
        vectorize(lambda a, b: a + b, torch.from_numpy(A.copy()),
                  torch.from_numpy(B.copy()), max_instrs=2)


def test_scalar_and_small_constants_are_literals():
    small = torch.arange(4, dtype=torch.int32)
    tr = vectorize(lambda a: a[:4] + small, torch.from_numpy(A.copy()))
    assert [i.op for i in tr.instrs] == ["add"]
    assert tr.instrs[0].srcs == (tr.input_pages["in0"][0],)
