"""The port's NDP-resource kernels: the plain PyTorch versions against the
JAX package's oracles and Pallas kernels (interpret mode) on the CPU, the
public wrappers' contract, and — on a machine with a GPU and nvcc — each
CUDA kernel against its plain version.

The JAX package is imported inside the tests that compare against it, so
the CUDA case also runs where jax is not installed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build, bitserial, ops, ref, shift_add  # noqa: E402

# the grids of tests/test_kernels.py
INT_SHAPES = [(8, 128), (16, 256), (8, 512), (24, 384), (64, 128)]
INT_DTYPES = [np.int32, np.int8]
ADD_GRID = [(s, d) for d in INT_DTYPES for s in INT_SHAPES]
MUL_GRID = [(s, d) for d in INT_DTYPES for s in INT_SHAPES[:3]]
SHIFT_GRID = [(s, bits) for bits in (4, 8) for s in INT_SHAPES[:3]]


def _rand(rng, shape, dtype):
    if dtype == np.int8:
        return rng.integers(-128, 128, size=shape, dtype=dtype)
    return rng.integers(-2 ** 30, 2 ** 30, size=shape, dtype=dtype)


def _pair(shape, dtype, seed=42):
    rng = np.random.default_rng(seed)
    return _rand(rng, shape, dtype), _rand(rng, shape, dtype)


def _t(x):
    return torch.from_numpy(np.array(x))


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
], ids=["1d", "shapes", "float", "mixed_dtypes", "shift_add_int8"])
def test_ops_reject_what_the_contract_excludes(call):
    with pytest.raises((ValueError, TypeError)):
        call()


@pytest.mark.parametrize("launch", [
    lambda a: bitserial.bitserial_add(a, a),
    lambda a: bitserial.bitserial_mul(a, a),
    lambda a: shift_add.shift_add_mul(a, a, bits=8),
], ids=["bitserial_add", "bitserial_mul", "shift_add_mul"])
def test_kernel_wrappers_never_fall_back_to_the_cpu(launch):
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        launch(torch.zeros(8, 128, dtype=torch.int32))
    assert ops.launch_counts() == before


@pytest.mark.cuda
def test_cuda_kernels_equal_their_plain_versions():
    """Run on the card with ``python -m pytest --noconftest -m cuda
    tests/test_torch_kernels.py``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    if _build.find_nvcc() is None:
        pytest.skip("needs nvcc to build csrc/ndp.cu: not found")
    ops.reset_launch_counts()
    cases = ([("bitserial_add", s, d, 8) for s, d in ADD_GRID]
             + [("bitserial_mul", s, d, 8) for s, d in MUL_GRID]
             + [("shift_add_mul", s, np.int32, bits)
                for s, bits in SHIFT_GRID])
    plain = {"bitserial_add": lambda a, b, bits: ref.bitserial_add_plain(a, b),
             "bitserial_mul": lambda a, b, bits: ref.bitserial_mul_plain(a, b),
             "shift_add_mul": ref.shift_add_mul_plain}
    for kernel, shape, dtype, bits in cases:
        a, b = (_t(x).cuda() for x in _pair(shape, dtype))
        got = (ops.shift_add_mul(a, b, bits=bits) if kernel == "shift_add_mul"
               else getattr(ops, kernel)(a, b))
        torch.cuda.synchronize()
        assert torch.equal(got, plain[kernel](a, b, bits)), (kernel, shape,
                                                             dtype, bits)
    assert ops.launch_counts() == {"bitserial_add": len(ADD_GRID),
                                   "bitserial_mul": len(MUL_GRID),
                                   "shift_add_mul": len(SHIFT_GRID)}
