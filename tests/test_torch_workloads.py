"""The port's workloads against the JAX package's: same tables and inputs,
bit-equal numeric runs, same simulated results from their own traces."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _golden  # noqa: E402
from repro import workloads as repro_workloads  # noqa: E402
from repro.sim import simulate as repro_simulate  # noqa: E402
from repro_torch import workloads  # noqa: E402
from repro_torch.sim import simulate  # noqa: E402

NAMES = ("aes", "xor_filter", "heat3d", "jacobi1d")
POLICIES = ("cpu", "isp", "pud", "dm", "bw", "conduit", "ideal")
SCALES = ("tiny", "paper")


def _outputs(result):
    return result if isinstance(result, tuple) else (result,)


@pytest.mark.parametrize("name", NAMES)
def test_tables_match_the_reference(name):
    got, want = workloads.WORKLOADS[name], repro_workloads.WORKLOADS[name]
    assert got.SCALES == want.SCALES
    assert got.SIM == want.SIM
    assert got.META == want.META


def test_the_port_carries_four_workloads():
    assert set(workloads.WORKLOADS) == set(NAMES)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("name", NAMES)
def test_make_inputs_equal_the_reference(name, scale, seed):
    got = workloads.make_inputs(name, scale, seed=seed, device="cpu")
    want = repro_workloads.WORKLOADS[name].make_inputs(scale, seed=seed)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("name", NAMES)
def test_run_numeric_is_bit_equal(name, scale):
    got = _outputs(workloads.run_numeric(name, scale, device="cpu"))
    want = _outputs(repro_workloads.run_numeric(name, scale))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.device.type == "cpu"
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
