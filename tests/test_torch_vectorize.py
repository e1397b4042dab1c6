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
# float32 operands of the matrix products and the LLM ops
XM = RNG.standard_normal((64, 512)).astype(np.float32)       # 2 pages
WM = RNG.standard_normal((512, 1024)).astype(np.float32)     # 32 pages
WT = RNG.standard_normal((1024, 512)).astype(np.float32)
QH = RNG.standard_normal((4, 64, 128)).astype(np.float32)    # heads, seq, dh
KH = RNG.standard_normal((4, 64, 128)).astype(np.float32)
PH = RNG.standard_normal((4, 64, 64)).astype(np.float32)     # heads, q, k
LG = RNG.standard_normal((8, 8192)).astype(np.float32)       # 4 pages
J_C, T_C = jnp.asarray(C), torch.from_numpy(C.copy())
# two more captured constants, for a loop that closes over several
D = RNG.integers(-64, 64, size=(20000,), dtype=np.int32)
E = RNG.integers(-64, 64, size=(20000,), dtype=np.int32)
J_D, T_D = jnp.asarray(D), torch.from_numpy(D.copy())
J_E, T_E = jnp.asarray(E), torch.from_numpy(E.copy())


def _jax_while(a, b):
    """A loop whose body reads a captured constant (a body const)."""
    def body(c):
        i, t = c
        return i + 1, t ^ J_C
    return jax.lax.while_loop(lambda c: c[0] < 3, body, (0, a[:20000]))


def _torch_while(a, b):
    return while_loop(lambda i, t: i < 3, lambda i, t: (i + 1, t ^ T_C),
                      (torch.tensor(0), a[:20000]))


def _jax_while_shared(a, b):
    """cond closes over D; body over E, then D: D is a cond const and a
    body const, first used in the body after E."""
    def cond(c):
        return c[0] < 3 + (c[1][0] ^ J_D[0]) * 0

    def body(c):
        i, t = c
        return i + 1, (t ^ J_E) ^ J_D
    return jax.lax.while_loop(cond, body, (0, a[:20000]))


def _torch_while_shared(a, b):
    return while_loop(lambda i, t: i < 3 + (t[0] ^ T_D[0]) * 0,
                      lambda i, t: (i + 1, (t ^ T_E) ^ T_D),
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
    "while_loop_shared_consts": (_jax_while_shared, _torch_while_shared,
                                 (A, B)),
    # x[r] is slice + squeeze; [8, 8192] ^ [8192] promotes the rank first
    "select_broadcast": (lambda x: x ^ x[3], lambda x: x ^ x[3], (X,)),
    "where_scalars": (lambda a, b: jnp.where(a > b, 1, 0),
                      lambda a, b: torch.where(a > b, 1, 0), (A, B)),
    "pad_3d": (lambda u: jax.lax.pad(u, jnp.array(0, u.dtype),
                                     [(1, 1, 0), (2, 0, 0), (0, 3, 0)]),
               lambda u: torch.nn.functional.pad(u, (0, 3, 2, 0, 1, 1)),
               (U,)),
    # matrix products: dot_general; x @ w.T keeps its transpose, einsum
    # adds none (and one where the result order is not dot_general's)
    "matmul": (lambda x, w: x @ w, lambda x, w: x @ w, (XM, WM)),
    "matmul_wT": (lambda x, w: x @ w.T, lambda x, w: x @ w.T, (XM, WT)),
    "einsum_qk": (lambda q, k: jnp.einsum("hqd,hkd->hqk", q, k),
                  lambda q, k: torch.einsum("hqd,hkd->hqk", q, k),
                  (QH, KH)),
    "einsum_pv": (lambda p, v: jnp.einsum("hqk,hkd->hqd", p, v),
                  lambda p, v: torch.einsum("hqk,hkd->hqd", p, v),
                  (PH, KH)),
    "einsum_out_transposed": (
        lambda q, k: jnp.einsum("hqd,hkd->khq", q, k),
        lambda q, k: torch.einsum("hqd,hkd->khq", q, k), (QH, KH)),
    # ATen's clone + _unsafe_view is JAX's free reshape after a transpose
    "permute_reshape": (lambda q: q.transpose(1, 0, 2).reshape(64, -1) * 2,
                        lambda q: q.permute(1, 0, 2).reshape(64, -1) * 2,
                        (QH,)),
    "mean_keepdim": (lambda x: jnp.mean(x * x, axis=-1, keepdims=True),
                     lambda x: (x * x).mean(-1, keepdim=True), (XM,)),
    "sum_keepdim": (lambda x: jnp.sum(x, axis=1, keepdims=True),
                    lambda x: x.sum(1, keepdim=True), (XM,)),
    "softmax": (lambda p: jax.nn.softmax(p, axis=-1),
                lambda p: torch.softmax(p, dim=-1), (PH,)),
    "silu": (jax.nn.silu, lambda x: torch.nn.functional.silu(x), (XM,)),
    # a negative index is a run-time normalisation + dynamic_slice in jax
    "select_last_argmax": (lambda x: jnp.argmax(x[-1]),
                           lambda x: torch.argmax(x[-1]), (LG,)),
    "select_negative": (lambda x: x[-3] * 2, lambda x: x[-3] * 2, (X,)),
    "unsqueeze_cat": (lambda a, b: jnp.concatenate([a[1:], b[7][None]]),
                      lambda a, b: torch.cat([a[1:], b[7][None]]), (A, B)),
    "stack": (lambda a, b: jnp.stack([a, b, a]),
              lambda a, b: torch.stack([a, b, a]), (A, B)),
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


def first_difference(got, want) -> str:
    """The first instruction where two traces' streams differ, with its
    tag (the primitive that emitted it) on both sides; "" if none."""
    a, b = stream(got), stream(want)
    for k, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return (f"instruction {k}: port {x} ({got.instrs[k].tag}), "
                    f"reference {y} ({want.instrs[k].tag})")
    if len(a) != len(b):
        return f"lengths {len(a)} and {len(b)}"
    return ""


def assert_same_trace(got, want):
    assert stream(got) == stream(want), first_difference(got, want)
    assert page_table(got) == page_table(want)
    assert got.input_pages == want.input_pages
    assert got.output_pages == want.output_pages


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_one_primitive_program_matches_repro(name):
    got, want = both(name)
    assert_same_trace(got, want)


@pytest.mark.parametrize("name", ["add", "reduce_sum", "slice_2d",
                                  "select_last_argmax", "matmul"])
def test_unquantized_matches_repro(name):
    got, want = both(name, quantize=False)
    assert_same_trace(got, want)


@pytest.mark.parametrize("k_steps", [4, 16])
@pytest.mark.parametrize("name", ["matmul", "einsum_qk", "einsum_pv"])
def test_matmul_k_steps_match_repro(name, k_steps):
    got, want = both(name, matmul_k_steps=k_steps)
    assert_same_trace(got, want)
    # one mul + add per output page and contraction macro-iteration
    out_pages = len(got.output_pages[0])
    assert [i.op for i in got.instrs].count("mul") == out_pages * k_steps


def test_einsum_is_one_dot_general_without_shuffles():
    """torch.einsum is captured as one node, not ATen's permute / view /
    bmm chain: the stream holds the product's mul + add pairs only."""
    got, want = both("einsum_qk")
    assert {i.op for i in got.instrs} == {"mul", "add"}
    assert_same_trace(got, want)


def assert_same_workload_trace(name, scale):
    """Fresh traces of one workload by both tracers.  Not ``get_trace``'s
    cached ones: ``simulate`` moves the pages of the trace it runs, and
    another test in the process may have simulated a cached trace."""
    got_mod, want_mod = WORKLOADS[name], REPRO_WORKLOADS[name]
    kw = getattr(want_mod, "VECTORIZE_KW", {})
    assert getattr(got_mod, "VECTORIZE_KW", {}) == kw
    got = vectorize(got_mod.make_fn(scale),
                    *got_mod.make_inputs(scale, device="cpu"), name=name,
                    **kw)
    want = repro_vectorize(want_mod.make_fn(scale),
                           *want_mod.make_inputs(scale), name=name, **kw)
    assert_same_trace(got, want)
    assert got.characterize().as_row() == want.characterize().as_row()
    assert (dataclasses.asdict(got.characterize())
            == dataclasses.asdict(want.characterize()))


@pytest.mark.parametrize("scale", ["tiny", "paper"])
def test_jacobi1d_trace_matches_repro(scale):
    assert_same_workload_trace("jacobi1d", scale)


@pytest.mark.parametrize("scale", ["tiny", "paper"])
@pytest.mark.parametrize("name", ["aes", "xor_filter", "heat3d",
                                  "llama2_infer", "llm_train"])
def test_workload_trace_matches_repro(name, scale):
    """while_loop, gathers, ``%``, ``where``, ``x[r]`` with a rank
    broadcast and 3-D ``pad``; matrix products, einsums, softmax, RMSNorm,
    ``logits[-1]`` and the decode feed; a gradient recorded as
    ``jax.value_and_grad`` records it, on the paper's own programs."""
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


def test_while_operands_are_cond_consts_body_consts_carries():
    """JAX's ``while`` reads its cond consts, its body consts (each in
    first-use order), then its carries; a tensor that cond and body both
    close over is read twice.  The port walks the HOP's sub-graphs for
    that order."""
    got, want = both("while_loop_shared_consts")
    assert_same_trace(got, want)
    srcs = got.instrs[0].srcs
    # D's page, E's page, D's page again, then the carry's
    assert len(srcs) == 4 and srcs[0] == srcs[2] != srcs[1]


def test_budget_exceeded_raises():
    with pytest.raises(TraceBudgetExceeded, match="max_instrs=2"):
        vectorize(lambda a, b: a + b, torch.from_numpy(A.copy()),
                  torch.from_numpy(B.copy()), max_instrs=2)


def test_matmul_no_longer_takes_the_control_fallback():
    got, _ = both("matmul_wT")
    assert all(i.vectorizable for i in got.instrs)
    assert [i.op for i in got.instrs][:1] == ["shuffle"]      # w.T


def test_scalar_and_small_constants_are_literals():
    small = torch.arange(4, dtype=torch.int32)
    tr = vectorize(lambda a: a[:4] + small, torch.from_numpy(A.copy()))
    assert [i.op for i in tr.instrs] == ["add"]
    assert tr.instrs[0].srcs == (tr.input_pages["in0"][0],)
