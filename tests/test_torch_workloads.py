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

NAMES = ("aes", "xor_filter", "heat3d", "jacobi1d", "llama2_infer")
POLICIES = ("cpu", "isp", "pud", "dm", "bw", "conduit", "ideal")
SCALES = ("tiny", "paper")
# run_numeric's output dtype where it is not the reference's int32: the
# tokens of torch.argmax are int64 (jnp.argmax gives int32)
OUTPUT_DTYPES = {"llama2_infer": torch.int64}


def _outputs(result):
    return result if isinstance(result, tuple) else (result,)


@pytest.mark.parametrize("name", NAMES)
def test_tables_match_the_reference(name):
    got, want = workloads.WORKLOADS[name], repro_workloads.WORKLOADS[name]
    assert got.SCALES == want.SCALES
    assert got.SIM == want.SIM
    assert got.META == want.META


def test_the_port_carries_four_workloads():
    """Named when the port carried four; llama2_infer is the fifth."""
    assert set(workloads.WORKLOADS) == set(NAMES)
    assert len(NAMES) == 5


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("name", NAMES)
def test_make_inputs_equal_the_reference(name, scale, seed):
    got = pytree.tree_leaves(
        workloads.make_inputs(name, scale, seed=seed, device="cpu"))
    want = jax.tree_util.tree_leaves(
        repro_workloads.WORKLOADS[name].make_inputs(scale, seed=seed))
    assert len(got) == len(want)          # params flatten in jax's order
    for g, w in zip(got, want):
        assert g.device.type == "cpu"
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("name", NAMES)
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
