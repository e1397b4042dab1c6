"""The port's NDP-resource kernels: the plain PyTorch versions against the
JAX package's oracles and Pallas kernels (interpret mode) on the CPU, the
public wrappers' contract, and — on a machine with a GPU and nvcc — each
CUDA kernel against its plain version.

The JAX package is imported inside the tests that compare against it, so
the CUDA case also runs where jax is not installed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (_build, attention, bitserial,  # noqa: E402
                                 int8_matmul, mws, ops, ref, scan, search,
                                 shift_add)

# the grids of tests/test_kernels.py
INT_SHAPES = [(8, 128), (16, 256), (8, 512), (24, 384), (64, 128)]
INT_DTYPES = [np.int32, np.int8]
ADD_GRID = [(s, d) for d in INT_DTYPES for s in INT_SHAPES]
MUL_GRID = [(s, d) for d in INT_DTYPES for s in INT_SHAPES[:3]]
SHIFT_GRID = [(s, bits) for bits in (4, 8) for s in INT_SHAPES[:3]]
MWS_OPS = ["and", "or", "xor", "nand", "nor"]
MWS_GRID = [(n, op, d) for d in INT_DTYPES for op in MWS_OPS
            for n in (2, 3, 7, 48)]
SEARCH_GRID = [(wpr, rows) for rows in (8, 24, 13) for wpr in (1, 2, 4)]
# the multiplier's edges: a ragged n (not a multiple of 32 elements, nor of
# a warp's 1024), and the extremes of each dtype as operand pairs
MUL_RAGGED = [((3, 37), np.int32), ((3, 37), np.int8), ((5, 413), np.int8)]
MUL_EXTREMES = {np.int32: [-2 ** 31, -1, 2 ** 31 - 1, 0, 1, 3],
                np.int8: [-128, 127, -1, 0, 1, 3]}
# the adder's edges: ragged n (not a multiple of a thread's 16 bytes, nor of
# a block's chunk) and the jacobi1d replay length
ADD_RAGGED = [((3, 37), np.int32), ((3, 37), np.int8), ((5, 413), np.int8),
              ((1, 655358), np.int32)]
# (M, K, N): the int8_matmul grid of tests/test_kernels.py, then shapes that
# divide nothing
MATMUL_GRID = [(32, 64, 32), (16, 32, 48), (128, 128, 128), (64, 96, 160)]
MATMUL_RAGGED = [(13, 37, 29), (1, 1, 1), (3, 5, 130)]


def _rand(rng, shape, dtype):
    if dtype == np.int8:
        return rng.integers(-128, 128, size=shape, dtype=dtype)
    return rng.integers(-2 ** 30, 2 ** 30, size=shape, dtype=dtype)


def _pair(shape, dtype, seed=42):
    rng = np.random.default_rng(seed)
    return _rand(rng, shape, dtype), _rand(rng, shape, dtype)


def _t(x):
    return torch.from_numpy(np.array(x))


def _extremes(dtype):
    """Every ordered pair of ``MUL_EXTREMES[dtype]`` as ``[1, n]``
    operands."""
    a, b = np.meshgrid(np.array(MUL_EXTREMES[dtype], dtype),
                       np.array(MUL_EXTREMES[dtype], dtype))
    return a.reshape(1, -1), b.reshape(1, -1)


def _stack(n_ops, dtype, seed=42):
    """An operand stack of the shape tests/test_kernels.py sweeps."""
    return _rand(np.random.default_rng(seed), (n_ops, 16, 256), dtype)


def _records(wpr, rows, seed=42):
    """``stack[rows, 32]`` with the query planted as record 0 of row 3, as
    tests/test_kernels.py plants it."""
    stack = _rand(np.random.default_rng(seed), (rows, 32), np.int32)
    stack[3, :wpr] = np.arange(wpr)
    return stack, np.arange(wpr, dtype=np.int32)


def _matmul_operands(m, k, n, seed=42):
    rng = np.random.default_rng(seed)
    return _rand(rng, (m, k), np.int8), _rand(rng, (k, n), np.int8)


def _reference():
    """(jax.numpy, repro.kernels.ops, repro.kernels.ref)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as repro_ops
    from repro.kernels import ref as repro_ref
    return jnp, repro_ops, repro_ref


@pytest.mark.parametrize("shape,dtype", ADD_GRID)
def test_bitserial_add_plain_equals_repro_oracle(shape, dtype):
    jnp, _, repro_ref = _reference()
    a, b = _pair(shape, dtype)
    want = np.asarray(repro_ref.ref_bitserial_add(jnp.asarray(a),
                                                  jnp.asarray(b)))
    np.testing.assert_array_equal(
        ref.bitserial_add_plain(_t(a), _t(b)).numpy(), want)
    np.testing.assert_array_equal(
        ref.ref_bitserial_add(_t(a), _t(b)).numpy(), want)


@pytest.mark.parametrize("case", ADD_GRID + ADD_RAGGED
                         + [("extremes", np.int32), ("extremes", np.int8)],
                         ids=str)
def test_bitserial_add_prefix_plain_equals_repro_oracle_and_pallas(case):
    """The prefix adder's gate sequence (Kogge-Stone levels; int8 as SWAR
    lanes of a word) against the JAX package's oracle and, where the Pallas
    kernel's tiling takes the shape (not at 655358 columns), its
    interpret-mode ripple adder."""
    jnp, repro_ops, repro_ref = _reference()
    shape, dtype = case
    a, b = _extremes(dtype) if shape == "extremes" else _pair(shape, dtype)
    want = np.asarray(repro_ref.ref_bitserial_add(jnp.asarray(a),
                                                  jnp.asarray(b)))
    if a.shape[1] <= 512 or a.shape[1] % 512 == 0:
        np.testing.assert_array_equal(
            np.asarray(repro_ops.bitserial_add(jnp.asarray(a),
                                               jnp.asarray(b))), want)
    got = ref.bitserial_add_prefix_plain(_t(a), _t(b))
    assert got.dtype == _t(a).dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape,dtype", MUL_GRID)
def test_bitserial_mul_plain_equals_repro_oracle(shape, dtype):
    jnp, _, repro_ref = _reference()
    a, b = _pair(shape, dtype)
    want = np.asarray(repro_ref.ref_bitserial_mul(jnp.asarray(a),
                                                  jnp.asarray(b)))
    np.testing.assert_array_equal(
        ref.bitserial_mul_plain(_t(a), _t(b)).numpy(), want)
    np.testing.assert_array_equal(
        ref.ref_bitserial_mul(_t(a), _t(b)).numpy(), want)


@pytest.mark.parametrize("case", MUL_GRID[:2] + MUL_GRID[3:5] + MUL_RAGGED
                         + [("extremes", np.int32), ("extremes", np.int8)],
                         ids=str)
def test_bitserial_mul_planes_plain_equals_repro_oracle_and_pallas(case):
    """The bit-plane multiplier's algorithm (transpose, MAJ/XOR full
    adders, transpose back) against the JAX package's oracle and its
    interpret-mode Pallas kernel."""
    jnp, repro_ops, repro_ref = _reference()
    shape, dtype = case
    a, b = _extremes(dtype) if shape == "extremes" else _pair(shape, dtype)
    want = np.asarray(repro_ref.ref_bitserial_mul(jnp.asarray(a),
                                                  jnp.asarray(b)))
    np.testing.assert_array_equal(
        np.asarray(repro_ops.bitserial_mul(jnp.asarray(a), jnp.asarray(b))),
        want)
    got = ref.bitserial_mul_planes_plain(_t(a), _t(b))
    assert got.dtype == _t(a).dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape,bits", SHIFT_GRID)
def test_shift_add_plain_equals_repro_oracle(shape, bits):
    jnp, _, repro_ref = _reference()
    a, b = _pair(shape, np.int32)
    want = np.asarray(repro_ref.ref_shift_add_mul(jnp.asarray(a),
                                                  jnp.asarray(b), bits))
    np.testing.assert_array_equal(
        ref.shift_add_mul_plain(_t(a), _t(b), bits).numpy(), want)
    np.testing.assert_array_equal(
        ref.ref_shift_add_mul(_t(a), _t(b), bits).numpy(), want)


# the IFP multiplier's edges: n % 4 = 1, 2, 3 (the elements after the
# kernel's last whole 16 bytes), the round counts at the ends of 0..32 and
# the replays' 8
SHIFT_RAGGED = [(1, 4097), (1, 4098), (1, 4099), (3, 37)]
SHIFT_EDGE_BITS = [0, 1, 8, 31, 32]
SHIFT_EXTREMES = [-2 ** 31, -1, 2 ** 31 - 1, 0, 1, 3, 41, 85]


def _shift_add_oracle(a, b, bits):
    """The JAX package's answer for ``a * (b & (2**bits - 1))``: its oracle
    ``ref_shift_add_mul``, except at bits = 32, where that oracle's mask
    (2**32 - 1) overflows int32 in JAX and the answer is its wrapping
    multiply ``ref_bitserial_mul``; at bits = 32 also its interpret-mode
    Pallas kernel, which takes the 32 rounds, where its tiling takes the
    shape (columns padded to 128 that 512-column blocks divide)."""
    jnp, repro_ops, repro_ref = _reference()
    if bits < 32:
        return np.asarray(repro_ref.ref_shift_add_mul(jnp.asarray(a),
                                                      jnp.asarray(b), bits))
    want = np.asarray(repro_ref.ref_bitserial_mul(jnp.asarray(a),
                                                  jnp.asarray(b)))
    cols = -(-a.shape[1] // 128) * 128
    if cols <= 512 or cols % 512 == 0:
        np.testing.assert_array_equal(
            np.asarray(repro_ops.shift_add_mul(jnp.asarray(a),
                                               jnp.asarray(b), bits=32)),
            want)
    return want


@pytest.mark.parametrize("shape,bits", [(s, b) for s in SHIFT_RAGGED
                                        for b in SHIFT_EDGE_BITS])
def test_shift_add_plain_edges_equal_repro(shape, bits):
    """Ragged n and the round counts at the ends of the kernel's range."""
    a, b = _pair(shape, np.int32, seed=bits)
    np.testing.assert_array_equal(
        ref.shift_add_mul_plain(_t(a), _t(b), bits).numpy(),
        _shift_add_oracle(a, b, bits))


@pytest.mark.parametrize("case", ["extremes 8", "extremes 32", "x85", "x41"])
def test_shift_add_plain_extremes_and_replay_multipliers_equal_repro(case):
    """Every ordered pair of int32's extremes (and the replays' multipliers)
    at 8 and 32 rounds; the jacobi1d (x85) and heat3d (x41) broadcast
    multipliers over random pages at 8 rounds."""
    if case.startswith("extremes"):
        bits = int(case.split()[1])
        a, b = np.meshgrid(np.array(SHIFT_EXTREMES, np.int32),
                           np.array(SHIFT_EXTREMES, np.int32))
        a, b = a.reshape(1, -1), b.reshape(1, -1)
    else:
        bits = 8
        a = _pair((3, 37), np.int32, seed=7)[0]
        b = np.full_like(a, int(case[1:]))
    np.testing.assert_array_equal(
        ref.shift_add_mul_plain(_t(a), _t(b), bits).numpy(),
        _shift_add_oracle(a, b, bits))


@pytest.mark.parametrize("n_ops,op,dtype", [
    pytest.param(*c, marks=pytest.mark.slow) if c[0] == 48 else c
    for c in MWS_GRID])
def test_mws_plain_equals_repro_oracle_and_pallas(n_ops, op, dtype):
    jnp, repro_ops, repro_ref = _reference()
    stack = _stack(n_ops, dtype)
    want = np.asarray(repro_ref.ref_mws(jnp.asarray(stack), op))
    np.testing.assert_array_equal(
        np.asarray(repro_ops.mws_bitwise(jnp.asarray(stack), op)), want)
    np.testing.assert_array_equal(ref.mws_plain(_t(stack), op).numpy(), want)
    np.testing.assert_array_equal(ref.ref_mws(_t(stack), op).numpy(), want)


@pytest.mark.parametrize("wpr,rows", SEARCH_GRID)
def test_search_plain_equals_repro_oracle_and_pallas(wpr, rows):
    jnp, repro_ops, repro_ref = _reference()
    stack, query = _records(wpr, rows)
    want = np.asarray(repro_ref.ref_search(jnp.asarray(stack),
                                           jnp.asarray(query)))
    assert want[3, 0]
    np.testing.assert_array_equal(
        np.asarray(repro_ops.search_pages(jnp.asarray(stack),
                                          jnp.asarray(query))), want)
    np.testing.assert_array_equal(
        ref.search_plain(_t(stack), _t(query)).numpy(), want)
    np.testing.assert_array_equal(
        ref.ref_search(_t(stack), _t(query)).numpy(), want)


# the match line's 16-byte path (records of 4 words): row counts, and row
# widths of 3 records (planted, near miss, planted) up to a page
SEARCH_CHUNKED = [(rows, words) for rows in (1, 13, 48)
                  for words in (12, 96, 1024)]


@pytest.mark.parametrize("rows,words", SEARCH_CHUNKED)
def test_search_chunked_plain_equals_repro_oracle_and_pallas(rows, words):
    """The match line on 16-byte records against the JAX package's oracle
    and its interpret-mode Pallas kernel, with the query planted in the
    first and the last record and a near miss (one bit off) in the
    second."""
    jnp, repro_ops, repro_ref = _reference()
    rng = np.random.default_rng(rows * 10000 + words)
    stack = _rand(rng, (rows, words), np.int32)
    query = _rand(rng, (4,), np.int32)
    stack[0, :4] = stack[0, 4:8] = stack[-1, -4:] = query
    stack[0, 7] ^= 1 << 30
    want = np.asarray(repro_ref.ref_search(jnp.asarray(stack),
                                           jnp.asarray(query)))
    assert want[0, 0] and want[-1, -1] and not want[0, 1]
    np.testing.assert_array_equal(
        np.asarray(repro_ops.search_pages(jnp.asarray(stack),
                                          jnp.asarray(query))), want)
    np.testing.assert_array_equal(
        ref.search_chunked_plain(_t(stack), _t(query)).numpy(), want)


def test_search_chunked_plain_takes_only_records_of_4_words():
    with pytest.raises(ValueError, match="records of 4 words"):
        ref.search_chunked_plain(torch.zeros(2, 24, dtype=torch.int32),
                                 torch.zeros(8, dtype=torch.int32))


@pytest.mark.parametrize("m,k,n", MATMUL_GRID)
def test_int8_matmul_plain_equals_repro_oracle_and_pallas(m, k, n):
    jnp, repro_ops, repro_ref = _reference()
    a, b = _matmul_operands(m, k, n)
    want = np.asarray(repro_ref.ref_int8_matmul(jnp.asarray(a),
                                                jnp.asarray(b)))
    np.testing.assert_array_equal(
        np.asarray(repro_ops.int8_matmul(jnp.asarray(a), jnp.asarray(b))),
        want)
    got = ref.int8_matmul_plain(_t(a), _t(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ref.ref_int8_matmul(_t(a), _t(b)).numpy(),
                                  want)


@pytest.mark.parametrize("k", [4096, 1 << 17])
def test_int8_matmul_plain_wraps_like_repro(k):
    """All -128: every sum is k * 2**14, which wraps at k = 2**17."""
    jnp, _, repro_ref = _reference()
    a = np.full((3, k), -128, np.int8)
    b = np.full((k, 2), -128, np.int8)
    want = np.asarray(repro_ref.ref_int8_matmul(jnp.asarray(a),
                                                jnp.asarray(b)))
    assert want[0, 0] == (k * 2 ** 14 + 2 ** 31) % 2 ** 32 - 2 ** 31
    np.testing.assert_array_equal(
        ref.int8_matmul_plain(_t(a), _t(b)).numpy(), want)


# (M, K, N, splits) for the split-K rehearsal: K of 8 and 22 stages (the
# replays' 1024 and 2816) cut 1-8 ways, most with a ragged last range, and
# K not a multiple of a stage
SPLITK_CASES = ([(16, 1024, 32, s) for s in range(1, 9)]
                + [(5, 2816, 24, s) for s in (3, 5, 8)]
                + [(7, 1000, 9, s) for s in (1, 2, 3, 4)])


@pytest.mark.parametrize("m,k,n,splits", SPLITK_CASES)
def test_int8_matmul_splitk_plain_equals_repro_oracle_and_pallas(m, k, n,
                                                                 splits):
    """Each K range's product wrapped to int32 and the ranges summed with
    int32 wrap in a shuffled order give the JAX package's product; at K =
    1024 also its interpret-mode Pallas kernel's (blocks of 128 K)."""
    jnp, repro_ops, repro_ref = _reference()
    a, b = _matmul_operands(m, k, n, seed=splits)
    want = np.asarray(repro_ref.ref_int8_matmul(jnp.asarray(a),
                                                jnp.asarray(b)))
    if k == 1024:
        np.testing.assert_array_equal(
            np.asarray(repro_ops.int8_matmul(jnp.asarray(a),
                                             jnp.asarray(b))), want)
    for seed in (0, 1):
        got = ref.int8_matmul_splitk_plain(_t(a), _t(b), splits, seed=seed)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("splits", [1, 2, 8, 64])
def test_int8_matmul_splitk_plain_wraps_like_repro(splits):
    """All -128 at K = 2**17: every sum is 2**31, which wraps to -2**31
    however the ranges are cut and in whatever order they are added."""
    jnp, _, repro_ref = _reference()
    k = 1 << 17
    a = np.full((3, k), -128, np.int8)
    b = np.full((k, 2), -128, np.int8)
    want = np.asarray(repro_ref.ref_int8_matmul(jnp.asarray(a),
                                                jnp.asarray(b)))
    assert (want == -2 ** 31).all()
    np.testing.assert_array_equal(
        ref.int8_matmul_splitk_plain(_t(a), _t(b), splits).numpy(), want)


@pytest.mark.parametrize("kernel,dtype", [
    ("bitserial_add", np.int8), ("bitserial_mul", np.int32),
    ("shift_add_mul", np.int32)])
def test_ops_equal_repro_pallas_kernels(kernel, dtype):
    jnp, repro_ops, _ = _reference()
    a, b = _pair((8, 128), dtype, seed=5)
    want = np.asarray(getattr(repro_ops, kernel)(jnp.asarray(a),
                                                 jnp.asarray(b)))
    got = getattr(ops, kernel)(_t(a), _t(b))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(3, 5), (1, 1000), (7, 130)])
@pytest.mark.parametrize("kernel,dtype,oracle", [
    ("bitserial_add", np.int8, ref.ref_bitserial_add),
    ("bitserial_add", np.int32, ref.ref_bitserial_add),
    ("bitserial_mul", np.int8, ref.ref_bitserial_mul),
    ("shift_add_mul", np.int32, ref.ref_shift_add_mul)])
def test_ops_on_cpu_take_any_shape_and_launch_nothing(kernel, dtype, oracle,
                                                      shape):
    before = ops.launch_counts()
    a, b = _pair(shape, dtype, seed=11)
    got = getattr(ops, kernel)(_t(a), _t(b))
    assert got.shape == shape and got.dtype == _t(a).dtype
    assert torch.equal(got, oracle(_t(a), _t(b)))
    assert ops.launch_counts() == before


@pytest.mark.parametrize("op", MWS_OPS)
@pytest.mark.parametrize("dtype", INT_DTYPES)
def test_mws_on_cpu_takes_any_shape_and_launches_nothing(dtype, op):
    before = ops.launch_counts()
    stack = _t(_rand(np.random.default_rng(3), (5, 3, 131), dtype))
    got = ops.mws_bitwise(stack, op)
    assert got.shape == (3, 131) and got.dtype == stack.dtype
    assert torch.equal(got, ref.ref_mws(stack, op))
    assert ops.launch_counts() == before


@pytest.mark.parametrize("m,k,n", MATMUL_RAGGED + MATMUL_GRID[:1])
def test_int8_matmul_on_cpu_takes_any_shape_and_launches_nothing(m, k, n):
    before = ops.launch_counts()
    a, b = (_t(x) for x in _matmul_operands(m, k, n, seed=6))
    got = ops.int8_matmul(a, b)
    assert got.shape == (m, n) and got.dtype == torch.int32
    assert torch.equal(got, ref.ref_int8_matmul(a, b))
    assert torch.equal(ops.int8_matmul(a, b.T.contiguous().T),
                       got)                       # a strided view of B
    assert ops.launch_counts() == before


@pytest.mark.parametrize("wpr", [1, 3])
def test_search_on_cpu_takes_any_rows_and_launches_nothing(wpr):
    before = ops.launch_counts()
    stack = _t(_rand(np.random.default_rng(4), (13, 6 * wpr), np.int32))
    query = stack[5, wpr:2 * wpr].clone()
    got = ops.search_pages(stack, query)
    assert got.shape == (13, 6) and got.dtype == torch.bool and got[5, 1]
    assert torch.equal(got, ref.ref_search(stack, query))
    assert ops.launch_counts() == before


def _scan_shapes(b=2, s=5, di=32, n=16, n_b=None, a_len=None, h_n=None,
                 dtype=torch.float32):
    """Zero ``selective_scan`` operands: dt, u [b, s, di], B, C [b, n_b or
    s, n], a [a_len or di], h0 [b, di, h_n or n]."""
    def z(*shape):
        return torch.zeros(shape, dtype=dtype)
    return (z(b, s, di), z(b, s, di), z(b, n_b or s, n), z(b, n_b or s, n),
            z(a_len or di), z(b, di, h_n or n))


@pytest.mark.parametrize("call", [
    lambda: ops.bitserial_add(torch.zeros(8, dtype=torch.int32),
                              torch.zeros(8, dtype=torch.int32)),
    lambda: ops.bitserial_add(torch.zeros(2, 8, dtype=torch.int32),
                              torch.zeros(2, 4, dtype=torch.int32)),
    lambda: ops.bitserial_mul(torch.zeros(2, 8), torch.zeros(2, 8)),
    lambda: ops.bitserial_mul(torch.zeros(2, 8, dtype=torch.int8),
                              torch.zeros(2, 8, dtype=torch.int32)),
    lambda: ops.shift_add_mul(torch.zeros(2, 8, dtype=torch.int8),
                              torch.zeros(2, 8, dtype=torch.int8)),
    lambda: ops.mws_bitwise(torch.zeros(2, 8, dtype=torch.int32)),
    lambda: ops.mws_bitwise(torch.zeros(2, 2, 8), "and"),
    lambda: ops.mws_bitwise(torch.zeros(2, 2, 8, dtype=torch.int16)),
    lambda: ops.mws_bitwise(torch.zeros(2, 2, 8, dtype=torch.int32), "not"),
    lambda: ops.search_pages(torch.zeros(2, 8, dtype=torch.int32),
                             torch.zeros(3, dtype=torch.int32)),
    lambda: ops.search_pages(torch.zeros(2, 8, dtype=torch.int8),
                             torch.zeros(2, dtype=torch.int8)),
    lambda: ops.search_pages(torch.zeros(2, 8, dtype=torch.int32),
                             torch.zeros(1, 2, dtype=torch.int32)),
    lambda: ops.search_pages(torch.zeros(2, 8, dtype=torch.int32),
                             torch.zeros(0, dtype=torch.int32)),
    lambda: ops.int8_matmul(torch.zeros(2, 8, dtype=torch.int8),
                            torch.zeros(4, 3, dtype=torch.int8)),
    lambda: ops.int8_matmul(torch.zeros(8, dtype=torch.int8),
                            torch.zeros(8, 3, dtype=torch.int8)),
    lambda: ops.int8_matmul(torch.zeros(2, 8, dtype=torch.int32),
                            torch.zeros(8, 3, dtype=torch.int32)),
    lambda: ops.int8_matmul(torch.zeros(2, 8, dtype=torch.int8),
                            torch.zeros(8, 3, dtype=torch.uint8)),
    lambda: ops.int8_matmul(torch.zeros(0, 8, dtype=torch.int8),
                            torch.zeros(8, 3, dtype=torch.int8)),
    lambda: ops.flash_attention(*[torch.zeros(2, 8, 48)] * 3),
    lambda: ops.flash_attention(*[torch.zeros(2, 8, 16,
                                              dtype=torch.float16)] * 3),
    lambda: ops.flash_attention(torch.zeros(2, 8, 16),
                                torch.zeros(2, 8, 16, dtype=torch.bfloat16),
                                torch.zeros(2, 8, 16)),
    lambda: ops.flash_attention(torch.zeros(2, 8, 16), torch.zeros(2, 8, 16),
                                torch.zeros(2, 9, 16)),
    lambda: ops.flash_attention(torch.zeros(2, 8, 16), torch.zeros(3, 8, 16),
                                torch.zeros(3, 8, 16)),
    lambda: ops.flash_attention(torch.zeros(1, 2, 8, 16),
                                torch.zeros(1, 2, 8, 16),
                                torch.zeros(1, 2, 8, 16)),
    lambda: ops.flash_attention(torch.zeros(2, 0, 16), torch.zeros(2, 8, 16),
                                torch.zeros(2, 8, 16)),
    lambda: ops.flash_attention(torch.zeros(2, 8, 16), torch.zeros(2, 0, 16),
                                torch.zeros(2, 0, 16)),
    lambda: ops.selective_scan(*_scan_shapes(n_b=8)),
    lambda: ops.selective_scan(*_scan_shapes(a_len=31)),
    lambda: ops.selective_scan(*_scan_shapes(h_n=8)),
    lambda: ops.selective_scan(*_scan_shapes(s=0)),
    lambda: ops.selective_scan(*_scan_shapes(dtype=torch.float64)),
], ids=["1d", "shapes", "float", "mixed_dtypes", "shift_add_int8",
        "mws_2d", "mws_float", "mws_int16", "mws_op", "search_ragged",
        "search_int8", "search_query_2d", "search_empty_query",
        "matmul_inner_dims", "matmul_1d", "matmul_int32", "matmul_uint8",
        "matmul_empty", "attn_dh48", "attn_fp16", "attn_mixed_dtypes",
        "attn_kv_shapes", "attn_heads", "attn_4d", "attn_empty_q",
        "attn_empty_k", "scan_bc_steps", "scan_a", "scan_h0", "scan_empty",
        "scan_float64"])
def test_ops_reject_what_the_contract_excludes(call):
    with pytest.raises((ValueError, TypeError)):
        call()


@pytest.mark.parametrize("launch", [
    lambda a: bitserial.bitserial_add(a, a),
    lambda a: bitserial.bitserial_mul(a, a),
    lambda a: shift_add.shift_add_mul(a, a, bits=8),
    lambda a: mws.mws_bitwise(a.reshape(2, 4, 128), "xor"),
    lambda a: search.search_pages(a, a[0, :4].contiguous()),
    lambda a: int8_matmul.int8_matmul(a.to(torch.int8),
                                      a.to(torch.int8).T.contiguous()),
    lambda a: attention.flash_attention(*[a.float().reshape(2, 32, 16)] * 3,
                                        causal=True, scale=0.25),
    lambda a: scan.selective_scan(*_scan_shapes()),
], ids=["bitserial_add", "bitserial_mul", "shift_add_mul", "mws_bitwise",
        "search_pages", "int8_matmul", "flash_attention", "selective_scan"])
def test_kernel_wrappers_never_fall_back_to_the_cpu(launch):
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        launch(torch.zeros(8, 128, dtype=torch.int32))
    assert ops.launch_counts() == before


def test_search_routes_to_ifp():
    """The port's conduit policy sends a flash-resident ``search`` to the
    in-flash match primitive (tests/test_kernels.py's decision)."""
    from repro_torch.core.cost import SystemView
    from repro_torch.core.isa import Location, Resource, VectorInstr
    from repro_torch.core.policies import make_policy
    from repro_torch.hw.ssd_spec import DEFAULT_SSD
    pol = make_policy("conduit", DEFAULT_SSD)
    ins = VectorInstr(iid=0, op="search", vlen=DEFAULT_SSD.page_size,
                      elem_bytes=1, srcs=(0,), dst=1)
    view = SystemView(0.0, lambda r: 0.0, lambda i: 0.0,
                      lambda p: Location.FLASH)
    d = pol.select(ins, view)
    assert d.resource == Resource.IFP
    assert ins.native(Resource.IFP) == "ifp.mws_match"


@pytest.mark.cuda
def test_cuda_kernels_equal_their_plain_versions():
    """Run on the card with ``python -m pytest --noconftest -m cuda
    tests/test_torch_kernels.py``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    if _build.find_nvcc() is None:
        pytest.skip("needs nvcc to build csrc/ndp.cu: not found")
    ops.reset_launch_counts()
    mul_cases = (MUL_GRID + MUL_RAGGED + [((1, 655358), np.int32)]
                 + [("extremes", d) for d in MUL_EXTREMES])
    cases = ([("bitserial_add", s, d, 8) for s, d in ADD_GRID]
             + [("bitserial_mul", s, d, 8) for s, d in mul_cases]
             + [("shift_add_mul", s, np.int32, bits)
                for s, bits in SHIFT_GRID])
    plain = {"bitserial_add": lambda a, b, bits: ref.bitserial_add_plain(a, b),
             "bitserial_mul": lambda a, b, bits: ref.bitserial_mul_plain(a, b),
             "shift_add_mul": ref.shift_add_mul_plain}
    for kernel, shape, dtype, bits in cases:
        a, b = (_t(x).cuda() for x in (_extremes(dtype) if shape == "extremes"
                                        else _pair(shape, dtype)))
        got = (ops.shift_add_mul(a, b, bits=bits) if kernel == "shift_add_mul"
               else getattr(ops, kernel)(a, b))
        torch.cuda.synchronize()
        assert torch.equal(got, plain[kernel](a, b, bits)), (kernel, shape,
                                                             dtype, bits)
    # operands one element past an allocation's start (not 16-byte
    # aligned): the multiplier's element-at-a-time path on whole tiles
    for dtype in INT_DTYPES:
        a, b = (_t(x).cuda() for x in _pair((1, 2100), dtype, seed=3))
        a_off, b_off = (torch.empty(2101, dtype=t.dtype, device="cuda")[1:]
                        .reshape(1, -1) for t in (a, b))
        a_off.copy_(a)
        b_off.copy_(b)
        assert a_off.data_ptr() % 16 and b_off.data_ptr() % 16
        got = ops.bitserial_mul(a_off, b_off)
        torch.cuda.synchronize()
        assert torch.equal(got, ref.bitserial_mul_plain(a, b)), dtype
    for n_ops, op, dtype in MWS_GRID:
        stack = _t(_stack(n_ops, dtype)).cuda()
        got = ops.mws_bitwise(stack, op)
        torch.cuda.synchronize()
        assert torch.equal(got, ref.mws_plain(stack, op)), (n_ops, op, dtype)
    for wpr, rows in SEARCH_GRID:
        stack, query = (_t(x).cuda() for x in _records(wpr, rows))
        got = ops.search_pages(stack, query)
        torch.cuda.synchronize()
        assert torch.equal(got, ref.search_plain(stack, query)), (wpr, rows)
        assert bool(got[3, 0])
    assert ops.launch_counts() == {"bitserial_add": len(ADD_GRID),
                                   "bitserial_mul": len(mul_cases)
                                   + len(INT_DTYPES),
                                   "shift_add_mul": len(SHIFT_GRID),
                                   "mws_bitwise": len(MWS_GRID),
                                   "search_pages": len(SEARCH_GRID),
                                   "int8_matmul": 0, "flash_attention": 0,
                                   "selective_scan": 0}


@pytest.mark.cuda
def test_cuda_add_and_mws_edges_equal_their_plain_versions():
    """K2a and K1 on their ragged, unaligned and int8 paths: the adder on
    ragged n, the dtypes' extremes and the jacobi1d sweep's slices (+4 and
    +8 bytes); the sense at 1-6 pages and all five ops, on a ragged n, on a
    stack one element past an allocation's start, and on one page whose n
    leaves a tail after its 16-byte loads."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    if _build.find_nvcc() is None:
        pytest.skip("needs nvcc to build csrc/ndp.cu: not found")
    ops.reset_launch_counts()
    pairs = [tuple(_t(x).cuda() for x in (_extremes(dtype) if shape ==
                                           "extremes" else _pair(shape, dtype)))
             for shape, dtype in ADD_RAGGED + [("extremes", np.int32),
                                               ("extremes", np.int8)]]
    for dtype in INT_DTYPES:                     # the jacobi1d slicing
        a = _t(_rand(np.random.default_rng(5), (655360,), dtype)).cuda()
        x0, x1, x2 = (s.reshape(1, -1) for s in (a[:-2], a[1:-1], a[2:]))
        assert x1.data_ptr() % 16 and x2.data_ptr() % 16
        pairs += [(x0, x1), (x1, x2), (x2, x0)]
    for a, b in pairs:
        got = ops.bitserial_add(a, b)
        torch.cuda.synchronize()
        assert torch.equal(got, ref.bitserial_add_plain(a, b)), (a.shape,
                                                                 a.dtype)
    stacks = []
    for dtype in INT_DTYPES:
        for n_ops in range(1, 7):
            stacks += [_t(_rand(np.random.default_rng(n_ops), (n_ops,) + rc,
                                dtype)).cuda() for rc in ((16, 256), (3, 37))]
            flat = torch.empty(n_ops * 4096 + 1, dtype=stacks[-1].dtype,
                               device="cuda")[1:]
            flat.copy_(stacks[-2].reshape(-1))
            stacks.append(flat.reshape(n_ops, 16, 256))
        stacks.append(_t(_rand(np.random.default_rng(9), (1, 1, 4099),
                               dtype)).cuda())
    for stack in stacks:
        for op in MWS_OPS:
            got = ops.mws_bitwise(stack, op)
            torch.cuda.synchronize()
            assert torch.equal(got, ref.mws_plain(stack, op)), (
                stack.shape, stack.dtype, stack.data_ptr() % 16, op)
    assert ops.launch_counts() == {
        **{k: 0 for k in ops.launch_counts()},
        "bitserial_add": len(pairs), "mws_bitwise": len(stacks) * 5}


def _offset(t, elems):
    """``t``'s values in a contiguous view ``elems`` elements past the
    start of an allocation on ``t``'s device."""
    flat = torch.empty(t.numel() + elems, dtype=t.dtype,
                       device=t.device)[elems:]
    flat.copy_(t.reshape(-1))
    return flat.view(t.shape)


@pytest.mark.cuda
def test_cuda_shift_add_edges_equal_its_plain_version():
    """K3 on its 16-byte and element paths: every round count 0..32 on
    aligned operands and on a view 4 bytes off, ragged n (n % 4 = 1, 2, 3),
    either operand at +4 or +8 bytes (the jacobi1d sweep's slices), and
    every ordered pair of int32's extremes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    if _build.find_nvcc() is None:
        pytest.skip("needs nvcc to build csrc/ndp.cu: not found")
    ops.reset_launch_counts()
    calls = []                                   # (a, b, bits)
    for bits in range(33):
        a, b = (_t(x).cuda() for x in _pair((8, 512), np.int32, seed=bits))
        calls += [(a, b, bits), (_offset(a, 1), b, bits)]
    for shape in SHIFT_RAGGED:
        a, b = (_t(x).cuda() for x in _pair(shape, np.int32, seed=2))
        calls += [(a, b, 8), (a, b, 13)]
    base = _t(_rand(np.random.default_rng(5), (1, 655360),
                    np.int32)).cuda()
    for k in (1, 2):
        x, y = base[:, :655358], base[:, k:k + 655358]
        assert y.data_ptr() % 16
        calls += [(x, y, 8), (y, x, 8)]
    a, b = np.meshgrid(np.array(SHIFT_EXTREMES, np.int32),
                       np.array(SHIFT_EXTREMES, np.int32))
    a, b = _t(a.reshape(1, -1)).cuda(), _t(b.reshape(1, -1)).cuda()
    calls += [(a, b, bits) for bits in (0, 1, 8, 31, 32)]
    for a, b, bits in calls:
        got = ops.shift_add_mul(a, b, bits=bits)
        torch.cuda.synchronize()
        assert torch.equal(got, ref.shift_add_mul_plain(a, b, bits)), (
            tuple(a.shape), a.data_ptr() % 16, b.data_ptr() % 16, bits)
    assert ops.launch_counts() == {**{k: 0 for k in ops.launch_counts()},
                                   "shift_add_mul": len(calls)}


@pytest.mark.cuda
def test_cuda_search_edges_equal_its_plain_version():
    """K4 on its two paths: wpr 4 (a 16-byte record a thread) and wpr 1,
    2, 3, 8, 16 and 32 (a record a thread, the query in shared memory), on
    1, 13 and 48 rows with a ragged record count, whole and on a stack view
    4 bytes off (which takes wpr 4 off its 16-byte path), the query planted
    in the first and the last record and a near miss in the second."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    if _build.find_nvcc() is None:
        pytest.skip("needs nvcc to build csrc/ndp.cu: not found")
    ops.reset_launch_counts()
    n = 0
    for wpr in (1, 2, 3, 4, 8, 16, 32):
        for rows, recs in ((1, 13), (13, 13), (48, 96)):
            rng = np.random.default_rng(wpr + rows)
            stack = _rand(rng, (rows, recs * wpr), np.int32)
            query = _rand(rng, (wpr,), np.int32)
            stack[0, :wpr] = stack[0, wpr:2 * wpr] = query
            stack[-1, -wpr:] = query
            stack[0, 2 * wpr - 1] ^= 1 << 30
            stack, query = _t(stack).cuda(), _t(query).cuda()
            for s in (stack, _offset(stack, 1)):
                got = ops.search_pages(s, query)
                torch.cuda.synchronize()
                assert torch.equal(got, ref.search_plain(stack, query)), (
                    wpr, rows, s.data_ptr() % 16)
                assert bool(got[0, 0]) and bool(got[-1, -1])
                assert not bool(got[0, 1])
                n += 1
    assert ops.launch_counts() == {**{k: 0 for k in ops.launch_counts()},
                                   "search_pages": n}


@pytest.mark.cuda
def test_cuda_flash_attention_takes_a_misaligned_view():
    """A contiguous q, k or v whose data pointer is not 16-byte aligned (a
    view at an odd offset, which ``.contiguous()`` returns unchanged) is
    copied before the launch and gives the plain version's answer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    if _build.find_nvcc() is None:
        pytest.skip("needs nvcc to build csrc/attention.cu: not found")
    ops.reset_launch_counts()
    for dtype, tol in ((torch.float32, 3e-5), (torch.bfloat16, 1e-2)):
        q, k, v = (_t(x).to("cuda", dtype) for x in _qkv(2, 37, 37, 64,
                                                          seed=4))
        views = []
        for t in (q, k, v):
            flat = torch.empty(t.numel() + 3, dtype=dtype, device="cuda")
            flat[3:].copy_(t.reshape(-1))
            views.append(flat[3:].view(t.shape))
        assert all(x.is_contiguous() and x.data_ptr() % 16 for x in views)
        got = ops.flash_attention(*views, causal=True)
        torch.cuda.synchronize()
        torch.testing.assert_close(
            got.float(), ref.flash_attention_plain(q, k, v).float(),
            atol=tol, rtol=tol)
    assert ops.launch_counts()["flash_attention"] == 2


@pytest.mark.cuda
def test_cuda_int8_matmul_equals_its_plain_version():
    """K5 on the card: exact on the grid, on shapes that divide nothing,
    on a strided B, and where the int32 sum wraps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    if _build.find_nvcc() is None:
        pytest.skip("needs nvcc to build csrc/ndp.cu: not found")
    ops.reset_launch_counts()
    shapes = MATMUL_GRID + MATMUL_RAGGED + [(48, 1024, 2816)]
    for m, k, n in shapes:
        a, b = (_t(x).cuda() for x in _matmul_operands(m, k, n))
        got = ops.int8_matmul(a, b)
        torch.cuda.synchronize()
        assert torch.equal(got, ref.int8_matmul_plain(a, b)), (m, k, n)
    a, b = (_t(x).cuda() for x in _matmul_operands(48, 64, 40, seed=9))
    assert torch.equal(ops.int8_matmul(a, b.T.contiguous().T),
                       ref.int8_matmul_plain(a, b))
    k = 1 << 17
    got = ops.int8_matmul(torch.full((3, k), -128, dtype=torch.int8,
                                     device="cuda"),
                          torch.full((k, 5), -128, dtype=torch.int8,
                                     device="cuda"))
    torch.cuda.synchronize()
    assert bool((got == -2 ** 31).all())
    assert ops.launch_counts()["int8_matmul"] == len(shapes) + 2


@pytest.mark.cuda
def test_cuda_int8_matmul_edges_equal_its_plain_version():
    """K5 on its byte-load and split paths: A or B a contiguous view one
    byte past an allocation's start, pitches not 16-byte aligned, a GEMV,
    a small K at a large M, and all -128 where the split sums wrap; each
    also unsplit and cut 3 ways."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    if _build.find_nvcc() is None:
        pytest.skip("needs nvcc to build csrc/ndp.cu: not found")

    def view(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device="cuda")[1:]
        flat.copy_(t.reshape(-1))
        return flat.view(t.shape)

    pairs = []
    for m, k, n in ((48, 1024, 1024), (13, 37, 29)):
        a, b = (_t(x).cuda() for x in _matmul_operands(m, k, n, seed=m))
        pairs += [(view(a), b), (a, view(b))]
        assert pairs[-2][0].data_ptr() % 16 and pairs[-1][1].data_ptr() % 16
    for m, k, n in ((48, 1030, 8200), (1, 1024, 8192), (1024, 48, 1024)):
        pairs.append(tuple(_t(x).cuda() for x in _matmul_operands(m, k, n)))
    pairs.append((torch.full((48, 1 << 17), -128, dtype=torch.int8,
                             device="cuda"),
                  torch.full((1 << 17, 64), -128, dtype=torch.int8,
                             device="cuda")))
    ops.reset_launch_counts()
    for a, b in pairs:
        want = ref.int8_matmul_plain(a, b)
        for splits in (0, 1, 3):
            got = int8_matmul.int8_matmul(a, b, splits=splits)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (tuple(a.shape), tuple(b.shape),
                                            splits)
        assert torch.equal(ops.int8_matmul(a, b), want)
    assert bool((want == -2 ** 31).all())
    assert ops.launch_counts()["int8_matmul"] == 4 * len(pairs)


# -- K6 flash attention -------------------------------------------------------
# (h, s, dh): the attention grid of tests/test_kernels.py
ATTN_GRID = [(2, 64, 32), (1, 128, 64), (4, 32, 16)]
# the smoke's cases beyond the grid: causal Sq != Sk, ragged lengths, and
# dh 128 (qwen3-4b); (h, sq, sk, dh)
ATTN_CROSS = [(2, 32, 128, 32), (3, 13, 37, 64), (2, 37, 13, 16),
              (1, 24, 40, 128)]
# q and k drawn x8 (bf16): logits of tens, so a row's running max changes
# inside a 64-key tile and the weights span many binades.  fp32 draws x4:
# at x8 the fp32 plain version is itself ~3.5e-5 from the float64 answer,
# over the fp32 tolerance of 3e-5, so no fp32 kernel could be held there
# (test_flash_attention_plain_fp32_conditioning pins both).
ATTN_LARGE = (2, 128, 128, 64)
LARGE_LOGITS = {torch.bfloat16: 8.0, torch.float32: 4.0}


def _qkv(h, sq, sk, dh, seed=0, qk_scale=1.0):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(h, sq, dh)) * qk_scale).astype(np.float32),
            (rng.normal(size=(h, sk, dh)) * qk_scale).astype(np.float32),
            rng.normal(size=(h, sk, dh)).astype(np.float32))


@pytest.mark.parametrize("h,s,d", ATTN_GRID)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_equals_repro_pallas_and_oracle(h, s, d,
                                                              causal):
    """fp32 at tests/test_kernels.py's tolerance (3e-5): the Pallas kernel
    (interpret mode) and, at Sq = Sk where their causal masks agree, the
    JAX package's oracle."""
    jnp, repro_ops, repro_ref = _reference()
    q, k, v = _qkv(h, s, s, d)
    got = ref.flash_attention_plain(_t(q), _t(k), _t(v), causal=causal)
    for want in (repro_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), causal=causal),
                 repro_ref.ref_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=causal)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_follows_the_pallas_kernel_at_sq_ne_sk(causal):
    """Sq 32, Sk 128: the causal mask is aligned top-left, as the Pallas
    kernel aligns it (ROADMAP R1)."""
    from repro.kernels import attention as repro_attention
    jnp, _, _ = _reference()
    q, k, v = _qkv(2, 32, 128, 32, seed=3)
    want = repro_attention.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=32, block_k=32, interpret=True)
    got = ref.flash_attention_plain(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5,
                               rtol=3e-5)


def test_flash_attention_plain_pins_r1_against_the_oracle():
    """ROADMAP R1: at h 2, Sq 32, Sk 128, dh 32 the JAX package's oracle
    aligns the causal mask bottom-right, so it sees up to 96 more keys per
    row than the kernel and the port; only the last row agrees."""
    jnp, _, repro_ref = _reference()
    q, k, v = _qkv(2, 32, 128, 32, seed=3)
    oracle = np.asarray(repro_ref.ref_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
    got = ref.flash_attention_plain(_t(q), _t(k), _t(v), causal=True).numpy()
    assert np.abs(got - oracle).max() > 0.5
    # the oracle's mask is the kernel's shifted by Sk - Sq
    shifted = ref.flash_attention_plain(
        _t(np.pad(q, ((0, 0), (96, 0), (0, 0)))), _t(k), _t(v),
        causal=True)[:, 96:].numpy()
    np.testing.assert_allclose(shifted, oracle, atol=3e-5, rtol=3e-5)


def test_flash_attention_plain_bf16_is_within_one_ulp_of_pallas():
    """bf16 operands: the plain version and the Pallas kernel both compute
    in fp32 and round the output once, so they differ by at most one bf16
    ulp (within atol/rtol 1e-2).  The CUDA bf16 kernel also rounds the
    softmax weights to bf16 (``ref.py`` states its tolerance)."""
    from repro.kernels import attention as repro_attention
    jnp, _, _ = _reference()
    q, k, v = _qkv(4, 64, 64, 64, seed=7)
    want = repro_attention.flash_attention(
        *(jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v)),
        causal=True, block_q=32, block_k=32, interpret=True)
    got = ref.flash_attention_plain(
        *(_t(x).to(torch.bfloat16) for x in (q, k, v)), causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, dtype=np.float32),
                               atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("h,sq,sk,dh,qk_scale",
                         [(h, s, s, d, 1.0) for h, s, d in ATTN_GRID]
                         + [c + (1.0,) for c in ATTN_CROSS]
                         + [ATTN_LARGE + (LARGE_LOGITS[torch.bfloat16],)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_tiled_plain_is_within_bf16_tolerance(h, sq, sk, dh,
                                                              qk_scale,
                                                              causal):
    """The bf16 kernel's numerics (64-key tiles, scale after the product,
    weights and normaliser from bf16-rounded weights) within 1e-2 of the
    plain version and of the interpret-mode Pallas kernel, bf16 operands."""
    jnp, repro_ops, _ = _reference()
    q, k, v = _qkv(h, sq, sk, dh, seed=11, qk_scale=qk_scale)
    tq, tk, tv = (_t(x).to(torch.bfloat16) for x in (q, k, v))
    got = ref.flash_attention_tiled_plain(tq, tk, tv, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == (h, sq, dh)
    pallas = repro_ops.flash_attention(
        *(jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v)),
        causal=causal)
    for want in (ref.flash_attention_plain(tq, tk, tv, causal=causal).float(),
                 torch.from_numpy(np.asarray(pallas, dtype=np.float32))):
        torch.testing.assert_close(got.float(), want, atol=1e-2, rtol=1e-2)


def test_flash_attention_plain_fp32_conditioning():
    """Why the fp32 large-logit case draws q, k x4 and not x8: the output's
    error grows with the logits' size, and at x8 the fp32 plain version is
    already more than the fp32 tolerance (3e-5) from the float64 answer,
    while at x4 it is well within it."""
    def error(qk_scale):
        q, k, v = (_t(x) for x in _qkv(*ATTN_LARGE, seed=28,
                                        qk_scale=qk_scale))
        exact = torch.softmax(
            (torch.einsum("hqd,hkd->hqk", q.double(), k.double())
             / np.sqrt(ATTN_LARGE[3])).masked_fill(
                 ~torch.ones(ATTN_LARGE[1], ATTN_LARGE[2],
                             dtype=torch.bool).tril(), -np.inf), dim=-1)
        exact = torch.einsum("hqk,hkd->hqd", exact, v.double())
        return float((ref.flash_attention_plain(q, k, v).double()
                      - exact).abs().max())
    assert error(LARGE_LOGITS[torch.float32]) < 3e-5 / 2
    assert error(LARGE_LOGITS[torch.bfloat16]) > 3e-5


def test_aligned16_copies_only_a_misaligned_operand():
    """The attention wrapper's copy of an operand not 16-byte aligned: a
    ``flat[3:]`` bf16 view comes back in a fresh, aligned tensor with the
    same values; an aligned tensor comes back as itself."""
    flat = torch.arange(3 + 2 * 8 * 16, dtype=torch.float32).to(
        torch.bfloat16)
    view = flat[3:].view(2, 8, 16)
    assert view.is_contiguous() and view.data_ptr() % 16
    got = attention.aligned16(view)
    assert got.data_ptr() % 16 == 0 and got.is_contiguous()
    assert got.dtype == torch.bfloat16 and torch.equal(got, view)
    aligned = torch.zeros(2, 8, 16, dtype=torch.bfloat16)
    assert attention.aligned16(aligned) is aligned


@pytest.mark.parametrize("h,sq,sk,dh", ATTN_CROSS)
def test_flash_attention_on_cpu_takes_any_lengths_and_launches_nothing(
        h, sq, sk, dh):
    before = ops.launch_counts()
    q, k, v = (_t(x) for x in _qkv(h, sq, sk, dh, seed=5))
    got = ops.flash_attention(q, k, v, causal=True, scale=0.3)
    assert got.shape == (h, sq, dh) and got.dtype == torch.float32
    assert torch.equal(got, ref.flash_attention_plain(q, k, v, True, 0.3))
    # ops takes strided views as they come
    assert torch.equal(ops.flash_attention(q.transpose(0, 1).contiguous()
                                           .transpose(0, 1), k, v,
                                           causal=True, scale=0.3), got)
    assert ops.launch_counts() == before


@pytest.mark.cuda
def test_cuda_flash_attention_equals_its_plain_version():
    """K6 on the card, fp32 at 3e-5 and bf16 at 1e-2 (the tolerance
    ``ref.py`` states), over the test grid, the cross, ragged and dh-128
    cases, and logits large enough to move the running max inside a
    tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    if _build.find_nvcc() is None:
        pytest.skip("needs nvcc to build csrc/attention.cu: not found")
    ops.reset_launch_counts()
    cases = [(h, s, s, d) for h, s, d in ATTN_GRID] + ATTN_CROSS
    n = 0
    for h, sq, sk, dh in cases + [ATTN_LARGE]:
        for causal in (True, False):
            for dtype, tol in ((torch.float32, 3e-5), (torch.bfloat16, 1e-2)):
                big = LARGE_LOGITS[dtype] if (h, sq, sk, dh) == ATTN_LARGE \
                    else 1.0
                q, k, v = (_t(x).to("cuda", dtype)
                           for x in _qkv(h, sq, sk, dh, seed=n, qk_scale=big))
                got = ops.flash_attention(q, k, v, causal=causal)
                torch.cuda.synchronize()
                want = ref.flash_attention_plain(q, k, v, causal=causal)
                torch.testing.assert_close(got.float(), want.float(),
                                           atol=tol, rtol=tol)
                n += 1
    assert ops.launch_counts()["flash_attention"] == n


# MLA's widths (DeepSeek-V2: q·k at 128 + 64, v at 128): one tile, several
# q tiles with the causal diagonal, ragged Sq != Sk, a single query row
ATTN_MLA = [(4, 64, 64), (8, 300, 300), (3, 77, 133), (2, 1, 150)]


@pytest.mark.cuda
def test_cuda_flash_attention_at_mla_widths_equals_its_plain_version():
    """K6's bf16 kernel at q·k depth 192 and v width 128 against the plain
    version at 1e-2 (``ref.py``), causal and not; its output is [H, Sq,
    128]; the fp32 kernel, built for equal widths, refuses the pair."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    if _build.find_nvcc() is None:
        pytest.skip("needs nvcc to build csrc/attention.cu: not found")
    rng = np.random.default_rng(9)
    for h, sq, sk in ATTN_MLA:
        for causal in (True, False):
            q, k = (torch.from_numpy(rng.normal(size=(h, s, 192)).astype(
                np.float32)).to("cuda", torch.bfloat16) for s in (sq, sk))
            v = torch.from_numpy(rng.normal(size=(h, sk, 128)).astype(
                np.float32)).to("cuda", torch.bfloat16)
            got = ops.flash_attention(q, k, v, causal=causal, scale=0.11)
            torch.cuda.synchronize()
            assert got.shape == (h, sq, 128)
            want = ref.flash_attention_plain(q, k, v, causal, 0.11)
            torch.testing.assert_close(got.float(), want.float(), atol=1e-2,
                                       rtol=1e-2)
    with pytest.raises(ValueError, match="dh = dv"):
        ops.flash_attention(q.float(), k.float(), v.float())


# -- the selective scan -------------------------------------------------------
# (B, S, di, N): zamba2's serving prefill, then a ragged di (not a multiple
# of a block's 128 channels) and S (not of a tile's 8 steps) at the smallest
# N the configs use (the reduced zamba2's 16), and N 32
SCAN_SERVE = (32, 1020, 4096, 64)
SCAN_RAGGED = [(3, 37, 200, 16), (2, 9, 130, 32)]
# The kernel's h update is one fma a state (h * decay unrounded) where the
# plain version rounds the two products and their sum, and it sums y over n
# in four interleaved partial sums, not in PyTorch's order: roundings of
# fp32 (2^-24 relative) that a decay under 1 keeps from growing over the
# steps.  Each output within SCAN_TOL of its tensor's largest magnitude.
SCAN_TOL = 1e-4


def _scan_operands(b, s, di, n, seed):
    """Operands on the card as ``mamba_apply`` makes them: dt a softplus,
    a = -exp(a_log) by channel, B and C views of one [b, s, 2n]
    projection."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    dt = torch.nn.functional.softplus(randn(b, s, di) - 1.0)
    u = randn(b, s, di)
    bc = randn(b, s, 2 * n) * n ** -0.5
    a = -torch.exp(0.5 * randn(di))
    return dt, u, bc[..., :n], bc[..., n:], a, randn(b, di, n) * 0.1


def _scan_close(got, want, what):
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    assert err <= SCAN_TOL * scale, (what, err, scale)


@pytest.mark.cuda
def test_cuda_selective_scan_equals_its_plain_version():
    """The kernel against its plain version at zamba2's serving shape,
    then one step (S = 1, a decode step) continuing the state it left;
    then ragged di and S at N 16 and 32, with a misaligned h0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    if _build.find_nvcc() is None:
        pytest.skip("needs nvcc to build csrc/scan.cu: not found")
    ops.reset_launch_counts()
    with torch.no_grad():
        b, s, di, n = SCAN_SERVE
        operands = _scan_operands(b, s, di, n, seed=0)
        assert operands[2].stride(1) == 2 * n       # B read in place
        y, h = ops.selective_scan(*operands)
        want_y, want_h = scan.selective_scan_plain(*operands)
        torch.cuda.synchronize()
        _scan_close(y, want_y, "y serve")
        _scan_close(h, want_h, "h serve")
        step = _scan_operands(b, 1, di, n, seed=1)[:5] + (h,)
        y1, h1 = ops.selective_scan(*step)
        want_y1, want_h1 = scan.selective_scan_plain(*step)
        torch.cuda.synchronize()
        _scan_close(y1, want_y1, "y step")
        _scan_close(h1, want_h1, "h step")
        del operands, y, h, want_y, want_h
        for case in SCAN_RAGGED:
            b, s, di, n = case
            *rest, h0 = _scan_operands(b, s, di, n, seed=di)
            off = torch.empty(h0.numel() + 1, device="cuda")[1:]
            off.copy_(h0.reshape(-1))
            operands = (*rest, off.view(h0.shape))
            assert operands[5].data_ptr() % 16
            y, h = ops.selective_scan(*operands)
            want_y, want_h = scan.selective_scan_plain(*operands)
            torch.cuda.synchronize()
            _scan_close(y, want_y, ("y", case))
            _scan_close(h, want_h, ("h", case))
    assert ops.launch_counts()["selective_scan"] == 2 + len(SCAN_RAGGED)


@pytest.mark.cuda
def test_cuda_zamba2_serves_the_loops_tokens():
    """The reduced zamba2 over ``mamba, mamba, sattn, mamba`` in fp32 on
    the card: prefill and decode through the scan kernel give the greedy
    tokens of the same no-grad run through the loop (``scan_steps``).
    The kernel's runs are counted in a device trace: a decode step that
    replays a CUDA graph runs it without a wrapper launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    if _build.find_nvcc() is None:
        pytest.skip("needs nvcc to build csrc/scan.cu: not found")
    import dataclasses
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models import ssm as S
    pattern = ("mamba", "mamba", "sattn", "mamba")
    cfg = dataclasses.replace(configs.get("zamba2-1.2b").reduced(),
                              dtype="float32", block_pattern=pattern,
                              n_layers=len(pattern))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = M.init_params(cfg, gen)
    n_req, batch, prompt, max_new = 4, 2, 32, 8

    def tokens():
        requests = serve.make_requests(cfg, n_req, prompt, max_new, seed=1)
        done = serve.serve_requests(cfg, params, requests, batch, prompt,
                                    max_new, "cuda")
        return [r.generated for r in done]

    ops.reset_launch_counts()
    with torch.no_grad():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            kernel = tokens()
            torch.cuda.synchronize()
        launched = ops.launch_counts()["selective_scan"]
        with S.scan_steps(10 ** 6):
            loop = tokens()
    runs = sum(1 for e in prof.profiler.kineto_results.events()
               if e.device_type() != DeviceType.CPU
               and "selective_scan_kernel" in e.name())
    assert runs == pattern.count("mamba") * max_new * n_req // batch
    assert ops.launch_counts()["selective_scan"] == launched
    assert kernel == loop
