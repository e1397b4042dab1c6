"""The port's multi-tenancy (``sim/tenancy.py``, ``sim/ftl.py``) against the
JAX package's: the two golden digests that need them on traces carried
across as plain data, ``simulate_mix`` on traces the port makes itself
against the same runs on the reference's traces, and the two modules as
textual copies of the reference that differ only in import paths."""
import dataclasses
import pathlib
import re

import pytest

torch = pytest.importorskip("torch")

import _golden  # noqa: E402
from _synth import synth_trace  # noqa: E402
from test_golden_equivalence import GOLDEN  # noqa: E402
from test_torch_engine import carry  # noqa: E402

from repro import sim as repro_sim  # noqa: E402
from repro.hw.ssd_spec import DEFAULT_SSD as REPRO_SSD  # noqa: E402
from repro.workloads import get_trace as repro_get_trace  # noqa: E402
from repro_torch import sim  # noqa: E402
from repro_torch.hw.ssd_spec import DEFAULT_SSD  # noqa: E402
from repro_torch.workloads import get_trace  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


def _gc_run(mod, a, b, **ftl_kw):
    """``_golden.scenario_gc``'s run through either package."""
    ftl = mod.FTLConfig(blocks_per_die=4, pages_per_block=8, prefill=0.9,
                        op_ratio=0.28, **ftl_kw)
    io = mod.HostIOStream(rate_iops=250_000, read_fraction=0.3,
                          n_requests=160, zipf_theta=0.95,
                          n_logical_pages=ftl.logical_pages())
    return mod.simulate_mix([a, b], "conduit", io_stream=io, ftl=ftl,
                            compute_solo=False)


def _io_run(mod, a, b, policy="conduit"):
    """``_golden.scenario_mix``'s run through either package."""
    io = mod.HostIOStream(rate_iops=80_000, n_requests=64, seed=7,
                          queue_depth=16)
    return mod.simulate_mix([a, b], policy, io_stream=io,
                            compute_solo=False)


@pytest.mark.parametrize("module", ["ftl", "tenancy"])
def test_module_is_the_reference_but_for_import_paths(module):
    ref = (SRC / "repro" / "sim" / f"{module}.py").read_text().splitlines()
    port = (SRC / "repro_torch" / "sim" / f"{module}.py").read_text(
        ).splitlines()
    assert len(port) == len(ref)
    for a, b in zip(ref, port):
        a = a.replace("repro.core.vectorize import Trace",
                      "repro.core.trace import Trace")
        assert re.sub(r"\brepro\.", "repro_torch.", a) == b


def test_carried_mix_trace_reproduces_golden_digest():
    a = carry(synth_trace(_golden.RAMP, name="A"))
    b = carry(synth_trace(_golden.MIXED, name="B"))
    assert _golden.digest_mix(_io_run(sim, a, b)) == GOLDEN["mix_2tenant_io"]


def test_carried_gc_trace_reproduces_golden_digest():
    a = carry(synth_trace(_golden.RAMP, name="A"))
    b = carry(synth_trace(_golden.MIXED, name="B"))
    assert _golden.digest_mix(_gc_run(sim, a, b)) == GOLDEN["gc_ftl"]


@pytest.mark.parametrize("victim", ["greedy", "cost_benefit", "wear_aware"])
@pytest.mark.parametrize("suspend", [False, True], ids=["mono", "suspend"])
def test_gc_policy_suite_matches_reference(victim, suspend):
    a, b = synth_trace(_golden.RAMP, name="A"), synth_trace(_golden.MIXED,
                                                           name="B")
    kw = dict(victim_policy=victim, gc_suspend=suspend)
    want = _golden.digest_mix(_gc_run(repro_sim, a, b, **kw))
    assert _golden.digest_mix(_gc_run(sim, carry(a), carry(b), **kw)) == want


@pytest.mark.parametrize("policy", ["conduit", "bw", "cpu"])
def test_mix_on_port_made_traces_equals_reference_made(policy):
    """jacobi1d and heat3d at tiny, traced by each package, mixed with
    host I/O: the port's run on its own traces gives the reference's
    digest."""
    ref = [repro_get_trace(n, "tiny") for n in ("jacobi1d", "heat3d")]
    port = [get_trace(n, "tiny", device="cpu") for n in ("jacobi1d",
                                                          "heat3d")]
    want = _golden.digest_mix(_io_run(repro_sim, *ref, policy=policy))
    assert _golden.digest_mix(_io_run(sim, *port, policy=policy)) == want


def test_gc_mix_on_port_made_traces_equals_reference_made():
    ref = [repro_get_trace(n, "tiny") for n in ("jacobi1d", "heat3d")]
    port = [get_trace(n, "tiny", device="cpu") for n in ("jacobi1d",
                                                          "heat3d")]
    want = _golden.digest_mix(_gc_run(repro_sim, *ref))
    assert _golden.digest_mix(_gc_run(sim, *port)) == want


def test_mix_with_solo_runs_reports_reference_slowdowns():
    a, b = synth_trace(_golden.RAMP, name="A"), synth_trace(_golden.MIXED,
                                                           name="B")
    want = repro_sim.simulate_mix([a, b], ["conduit", "isp"])
    got = sim.simulate_mix([carry(a), carry(b)], ["conduit", "isp"])
    assert got.slowdowns == want.slowdowns
    assert got.fairness == want.fairness
    assert got.summary() == want.summary()


def test_clone_trace_owns_its_page_table_and_shares_the_rest():
    tr = get_trace("jacobi1d", "tiny", device="cpu")
    twin = sim.clone_trace(tr)
    assert type(twin) is type(tr) and twin.name == tr.name
    assert twin.pages is not tr.pages
    assert twin.instrs is tr.instrs
    assert twin.input_pages is tr.input_pages


def test_zipf_overwrites_match_reference():
    ftl_kw = dict(blocks_per_die=4, pages_per_block=8, prefill=0.9,
                  op_ratio=0.28)
    got = sim.drive_zipf_overwrites(sim.FTLConfig(**ftl_kw), DEFAULT_SSD,
                                    300, seed=5)
    want = repro_sim.drive_zipf_overwrites(repro_sim.FTLConfig(**ftl_kw),
                                           REPRO_SSD, 300, seed=5)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_victim_registry_is_the_reference():
    assert sorted(sim.VICTIM_POLICIES) == sorted(repro_sim.VICTIM_POLICIES)
    for name in sim.VICTIM_POLICIES:
        assert type(sim.make_victim_policy(name, 0.5)).__name__ == type(
            repro_sim.make_victim_policy(name, 0.5)).__name__
