"""The port's jacobi1d workload against the JAX package's: same inputs,
bit-equal numeric run, same simulated results from its own trace."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _golden  # noqa: E402
from repro import workloads as repro_workloads  # noqa: E402
from repro.sim import simulate as repro_simulate  # noqa: E402
from repro.workloads import jacobi1d as repro_jacobi1d  # noqa: E402
from repro_torch import workloads  # noqa: E402
from repro_torch.sim import simulate  # noqa: E402
from repro_torch.workloads import jacobi1d  # noqa: E402

POLICIES = ("cpu", "isp", "pud", "dm", "bw", "conduit", "ideal")
SCALES = ("tiny", "paper")


def test_tables_match_the_reference():
    assert jacobi1d.SCALES == repro_jacobi1d.SCALES
    assert jacobi1d.SIM == repro_jacobi1d.SIM
    assert jacobi1d.META == repro_jacobi1d.META
    assert set(workloads.WORKLOADS) == {"jacobi1d"}


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("scale", SCALES)
def test_make_inputs_equal_the_reference(scale, seed):
    got = workloads.make_inputs("jacobi1d", scale, seed=seed, device="cpu")
    want = repro_jacobi1d.make_inputs(scale, seed=seed)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("scale", SCALES)
def test_run_numeric_is_bit_equal(scale):
    got = workloads.run_numeric("jacobi1d", scale, device="cpu")
    want = np.asarray(repro_workloads.run_numeric("jacobi1d", scale))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)   # int32 wraps alike


@pytest.mark.parametrize("policy", POLICIES)
def test_own_trace_simulates_like_repro(policy):
    got = simulate(workloads.get_trace("jacobi1d", "tiny", device="cpu"),
                   policy)
    want = repro_simulate(repro_workloads.get_trace("jacobi1d", "tiny"),
                          policy)
    assert _golden.digest_sim(got) == _golden.digest_sim(want)


@pytest.mark.parametrize("pressure", [0.0, 0.5])
def test_sim_config_for_matches_the_reference(pressure):
    got = workloads.sim_config_for(
        "jacobi1d", workloads.get_trace("jacobi1d", "tiny", device="cpu"),
        pressure=pressure)
    want = repro_workloads.sim_config_for(
        "jacobi1d", repro_workloads.get_trace("jacobi1d", "tiny"),
        pressure=pressure)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
