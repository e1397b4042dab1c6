"""The port's tracer (``make_fx`` ATen walk) against the JAX package's
jaxpr walk: the same program, written once in each framework and fed the
same numpy inputs, gives the same post-``_compact`` instruction stream and
page table."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch._higher_order_ops.while_loop import while_loop  # noqa: E402

from repro.core.vectorize import vectorize as repro_vectorize  # noqa: E402
from repro.workloads import WORKLOADS as REPRO_WORKLOADS  # noqa: E402
from repro_torch.core.trace import TraceBudgetExceeded  # noqa: E402
from repro_torch.core.vectorize import vectorize  # noqa: E402
from repro_torch.workloads import WORKLOADS  # noqa: E402

RNG = np.random.default_rng(7)
A = RNG.integers(-64, 64, size=(40000,), dtype=np.int32)   # 2.4 pages
B = RNG.integers(-64, 64, size=(40000,), dtype=np.int32)
X = RNG.integers(-64, 64, size=(8, 8192), dtype=np.int32)  # 4 pages
C = RNG.integers(-64, 64, size=(20000,), dtype=np.int32)   # captured
I = RNG.integers(0, 40000, size=(30000,), dtype=np.int32)   # indices into A
U = RNG.integers(-64, 64, size=(12, 20, 30), dtype=np.int32)
J_C, T_C = jnp.asarray(C), torch.from_numpy(C.copy())


def _jax_while(a, b):
    """A loop whose body reads a captured constant (a body const)."""
    def body(c):
        i, t = c
        return i + 1, t ^ J_C
    return jax.lax.while_loop(lambda c: c[0] < 3, body, (0, a[:20000]))


def _torch_while(a, b):
    return while_loop(lambda i, t: i < 3, lambda i, t: (i + 1, t ^ T_C),
                      (torch.tensor(0), a[:20000]))


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
    # nested ``jit`` in jax 0.9: one CONTROL region, pages named "jit"
    "where": (lambda a, b: jnp.where(a > 0, a, b),
              lambda a, b: torch.where(a > 0, a, b), (A, B)),
    "take": (jnp.take, lambda a, i: a[i], (A, I)),
    "remainder": (lambda a, b: a % 7, lambda a, b: a % 7, (A, B)),
    "cumsum": (lambda a, b: jnp.cumsum(a), lambda a, b: torch.cumsum(a, 0),
               (A, B)),
    "while_loop": (_jax_while, _torch_while, (A, B)),
    # x[r] is slice + squeeze; [8, 8192] ^ [8192] promotes the rank first
    "select_broadcast": (lambda x: x ^ x[3], lambda x: x ^ x[3], (X,)),
    "where_scalars": (lambda a, b: jnp.where(a > b, 1, 0),
                      lambda a, b: torch.where(a > b, 1, 0), (A, B)),
    "pad_3d": (lambda u: jax.lax.pad(u, jnp.array(0, u.dtype),
                                     [(1, 1, 0), (2, 0, 0), (0, 3, 0)]),
               lambda u: torch.nn.functional.pad(u, (0, 3, 2, 0, 1, 1)),
               (U,)),
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


def assert_same_workload_trace(name, scale):
    """Fresh traces of one workload by both tracers.  Not ``get_trace``'s
    cached ones: ``simulate`` moves the pages of the trace it runs, and
    another test in the process may have simulated a cached trace."""
    got_mod, want_mod = WORKLOADS[name], REPRO_WORKLOADS[name]
    got = vectorize(got_mod.make_fn(scale),
                    *got_mod.make_inputs(scale, device="cpu"), name=name)
    want = repro_vectorize(want_mod.make_fn(scale),
                           *want_mod.make_inputs(scale), name=name)
    assert_same_trace(got, want)
    assert got.characterize().as_row() == want.characterize().as_row()
    assert (dataclasses.asdict(got.characterize())
            == dataclasses.asdict(want.characterize()))


@pytest.mark.parametrize("scale", ["tiny", "paper"])
def test_jacobi1d_trace_matches_repro(scale):
    assert_same_workload_trace("jacobi1d", scale)


@pytest.mark.parametrize("scale", ["tiny", "paper"])
@pytest.mark.parametrize("name", ["aes", "xor_filter", "heat3d"])
def test_workload_trace_matches_repro(name, scale):
    """while_loop, gathers, ``%``, ``where``, ``x[r]`` with a rank
    broadcast and 3-D ``pad`` on the paper's own programs."""
    assert_same_workload_trace(name, scale)


def test_where_is_select_in_the_port_and_control_in_repro():
    """In jax 0.9 ``jnp.where`` is a nested ``jit`` that the reference walk
    does not enter: CONTROL ``scalar`` instructions over (c, x, y), pages
    named ``jit``.  The port's ``aten.where`` follows it exactly."""
    got, want = both("where")
    assert [i.op for i in got.instrs] == ["cmp"] * 3 + ["scalar"] * 3
    assert [i.vectorizable for i in got.instrs] == [True] * 3 + [False] * 3
    assert sum(e.name.startswith("jit[")
               for e in got.pages.entries.values()) == 3
    assert_same_trace(got, want)


def test_unknown_op_takes_the_control_fallback():
    """cumsum is CONTROL on both sides, pages named after the nested
    ``jit`` the reference does not enter."""
    got, want = both("cumsum")
    assert {i.op for i in got.instrs} == {"scalar"}
    assert not any(i.vectorizable for i in got.instrs)
    assert {i.tag for i in got.instrs} == {"jit"}
    assert_same_trace(got, want)


def test_budget_exceeded_raises():
    with pytest.raises(TraceBudgetExceeded, match="max_instrs=2"):
        vectorize(lambda a, b: a + b, torch.from_numpy(A.copy()),
                  torch.from_numpy(B.copy()), max_instrs=2)


def test_scalar_and_small_constants_are_literals():
    small = torch.arange(4, dtype=torch.int32)
    tr = vectorize(lambda a: a[:4] + small, torch.from_numpy(A.copy()))
    assert [i.op for i in tr.instrs] == ["add"]
    assert tr.instrs[0].srcs == (tr.input_pages["in0"][0],)
