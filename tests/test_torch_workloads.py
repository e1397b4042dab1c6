"""The port's workloads against the JAX package's: same tables and inputs,
bit-equal numeric runs, same simulated results from their own traces."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

import _golden  # noqa: E402
from repro import workloads as repro_workloads  # noqa: E402
from repro.sim import simulate as repro_simulate  # noqa: E402
from repro.workloads import _llama as repro_llama  # noqa: E402
from repro_torch import workloads  # noqa: E402
from repro_torch.sim import simulate  # noqa: E402
from repro_torch.workloads import _llama  # noqa: E402

NAMES = ("aes", "xor_filter", "heat3d", "jacobi1d", "llama2_infer",
         "llm_train")
# workloads whose run_numeric is integer and bit-equal to the reference's;
# llm_train's fp32 step is equal within a tolerance (TRAIN_TOL)
BIT_EQUAL = NAMES[:-1]
POLICIES = ("cpu", "isp", "pud", "dm", "bw", "conduit", "ideal")
SCALES = ("tiny", "paper")
# run_numeric's output dtype where it is not the reference's int32: the
# tokens of torch.argmax are int64 (jnp.argmax gives int32)
OUTPUT_DTYPES = {"llama2_infer": torch.int64}
# make_inputs arguments whose dtype is not the reference's, by workload:
# (argument position, dtype).  llm_train's labels are drawn as int32 and
# held as int64, the index type of torch.take_along_dim
INPUT_DTYPES = {"llm_train": (2, np.int64)}
# torch autograd against jax.value_and_grad in fp32: the loss within 1e-5,
# every updated parameter within 1e-6 (measured on the CPU: 9.5e-7 and
# 6.0e-8 at paper scale)
TRAIN_TOL = {"loss": 1e-5, "params": 1e-6}


def _outputs(result):
    return result if isinstance(result, tuple) else (result,)


@pytest.mark.parametrize("name", NAMES)
def test_tables_match_the_reference(name):
    got, want = workloads.WORKLOADS[name], repro_workloads.WORKLOADS[name]
    assert got.SCALES == want.SCALES
    assert got.SIM == want.SIM
    assert got.META == want.META


def test_the_port_carries_four_workloads():
    """Named when the port carried four; llama2_infer is the fifth and
    llm_train the sixth, all of the paper's Table 3."""
    assert set(workloads.WORKLOADS) == set(NAMES)
    assert set(workloads.WORKLOADS) == set(repro_workloads.WORKLOADS)
    assert len(NAMES) == 6


def test_paper_order_is_the_references():
    assert workloads.PAPER_ORDER == repro_workloads.PAPER_ORDER


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("name", NAMES)
def test_make_inputs_equal_the_reference(name, scale, seed):
    args = workloads.make_inputs(name, scale, seed=seed, device="cpu")
    got = pytree.tree_leaves(args)
    want = jax.tree_util.tree_leaves(
        repro_workloads.WORKLOADS[name].make_inputs(scale, seed=seed))
    assert len(got) == len(want)          # params flatten in jax's order
    other = {}
    if name in INPUT_DTYPES:
        pos, dtype = INPUT_DTYPES[name]
        other[len(pytree.tree_leaves(args[:pos]))] = dtype
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.device.type == "cpu"
        assert g.numpy().dtype == other.get(i, np.asarray(w).dtype)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("name", BIT_EQUAL)
def test_run_numeric_is_bit_equal(name, scale):
    got = _outputs(workloads.run_numeric(name, scale, device="cpu"))
    want = _outputs(repro_workloads.run_numeric(name, scale))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == OUTPUT_DTYPES.get(name, torch.int32)
        assert g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))  # wraps alike


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", NAMES)
def test_own_trace_simulates_like_repro(name, policy):
    got = simulate(workloads.get_trace(name, "tiny", device="cpu"), policy)
    want = repro_simulate(repro_workloads.get_trace(name, "tiny"), policy)
    assert _golden.digest_sim(got) == _golden.digest_sim(want)


@pytest.mark.parametrize("pressure", [0.0, 0.5])
@pytest.mark.parametrize("name", NAMES)
def test_sim_config_for_matches_the_reference(name, pressure):
    got = workloads.sim_config_for(
        name, workloads.get_trace(name, "tiny", device="cpu"),
        pressure=pressure)
    want = repro_workloads.sim_config_for(
        name, repro_workloads.get_trace(name, "tiny"), pressure=pressure)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("scale", SCALES)
def test_llm_train_step_is_within_tolerance_of_the_reference(scale):
    loss, new = workloads.run_numeric("llm_train", scale, device="cpu")
    want_loss, want_new = repro_workloads.run_numeric("llm_train", scale)
    assert loss.shape == () and loss.dtype == torch.float32
    assert abs(float(loss) - float(want_loss)) <= TRAIN_TOL["loss"]
    got, want = pytree.tree_leaves(new), jax.tree_util.tree_leaves(want_new)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == np.shape(w)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=TRAIN_TOL["params"])


def test_llm_train_params_carried_from_the_reference_train_alike():
    """The JAX package's weights, carried across by params_from_numpy,
    give the port's step the same result as its own draws."""
    want = repro_workloads.WORKLOADS["llm_train"].make_inputs("tiny")
    got = workloads.make_inputs("llm_train", "tiny", device="cpu")
    carried = _llama.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, want[0]), device="cpu")
    fn = workloads.WORKLOADS["llm_train"].make_fn("tiny")
    a_loss, a_new = fn(carried, *got[1:])
    b_loss, b_new = fn(*got)
    assert torch.equal(a_loss, b_loss)
    for a, b in zip(pytree.tree_leaves(a_new), pytree.tree_leaves(b_new)):
        assert torch.equal(a, b)


def _tiny_llama():
    p = workloads.WORKLOADS["llama2_infer"].SCALES["tiny"]
    want = repro_workloads.WORKLOADS["llama2_infer"].make_inputs("tiny")
    return p, want, workloads.make_inputs("llama2_infer", "tiny", device="cpu")


def test_params_from_numpy_equal_make_inputs():
    """The reference's weights, carried across as numpy, are the port's."""
    _, want, got = _tiny_llama()
    carried = _llama.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, want[0]), device="cpu")
    assert pytree.tree_structure(carried) == pytree.tree_structure(got[0])
    for c, g in zip(pytree.tree_leaves(carried), pytree.tree_leaves(got[0])):
        assert torch.equal(c, g)


def test_llama_forward_matches_the_reference():
    """fp32 logits of one forward; the two frameworks sum in other orders,
    so equal within rtol = atol = 1e-5 (logits are O(1))."""
    p, want, got = _tiny_llama()
    want_logits = np.asarray(repro_llama.forward(*want, p["n_heads"]))
    got_logits = _llama.forward(*got, p["n_heads"])
    assert got_logits.shape == want_logits.shape == (p["seq"], p["vocab"])
    np.testing.assert_allclose(got_logits.numpy(), want_logits, rtol=1e-5,
                               atol=1e-5)
