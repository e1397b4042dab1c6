"""``chip_smoke.py`` on the CPU: its pinned reference constants against the
JAX package, and its kernel replays rehearsed at "tiny" scale, where
``ops`` takes the kernels' plain versions (the card runs them at "paper"
through the CUDA kernels)."""
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from repro.sim import simulate as repro_simulate  # noqa: E402
from repro.workloads import get_trace as repro_get_trace  # noqa: E402
from repro.workloads import run_numeric as repro_run_numeric  # noqa: E402
from repro_torch import workloads  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

LABELS = [label for label, _, _ in chip_smoke.replay_plan({}, "tiny", "cpu")]


def test_reference_covers_every_ported_workload():
    assert set(chip_smoke.REFERENCE) == set(workloads.WORKLOADS)


@pytest.mark.parametrize("name", sorted(chip_smoke.REFERENCE))
def test_reference_constants_are_the_jax_packages(name):
    want = chip_smoke.REFERENCE[name]
    trace = repro_get_trace.__wrapped__(name, "paper")      # a fresh trace
    assert trace.characterize().as_row() == want["row"]
    assert (repro_simulate(trace, "conduit").makespan_ns
            == want["conduit_makespan_ns"])
    out = repro_run_numeric(name, "paper")
    outs = out if isinstance(out, tuple) else (out,)
    assert (chip_smoke.output_digest([np.asarray(o) for o in outs])
            == want["numeric_sha256"])


@pytest.fixture(scope="module")
def tiny_numeric():
    return {name: workloads.run_numeric(name, "tiny", device="cpu")
            for name in workloads.WORKLOADS}


@pytest.mark.parametrize("label", LABELS)
def test_replay_equals_the_numeric_run_on_the_cpu(label, tiny_numeric):
    (replay, want_counts), = [(r, c) for lab, r, c in chip_smoke.replay_plan(
        tiny_numeric, "tiny", "cpu") if lab == label]
    before = ops.launch_counts()
    got, want = replay()
    assert got.device.type == "cpu"
    assert torch.equal(got, want)
    assert ops.launch_counts() == before           # plain versions only
    assert any(want_counts.values())
