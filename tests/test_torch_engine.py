"""The port's engine (trace, cost, policies, simulator) against the JAX
package's, fed the same traces: a trace made by ``repro`` is carried across
as plain data (``trace_to_dict``) and must give the same digests, so an
engine fault shows apart from a tracer fault."""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import _golden  # noqa: E402
from _synth import synth_trace  # noqa: E402
from test_golden_equivalence import GOLDEN  # noqa: E402

from repro.hw.ssd_spec import DEFAULT_SSD as REPRO_SSD  # noqa: E402
from repro.sim import simulate as repro_simulate  # noqa: E402
from repro.workloads import get_trace as repro_get_trace  # noqa: E402
from repro_torch.core.trace import trace_from_dict, trace_to_dict  # noqa: E402
from repro_torch.hw.ssd_spec import DEFAULT_SSD  # noqa: E402
from repro_torch.sim import SimConfig, simulate  # noqa: E402

POLICIES = ("cpu", "isp", "pud", "dm", "bw", "conduit", "ideal")


def carry(trace):
    """A ``repro`` trace as a port Trace, through JSON text."""
    return trace_from_dict(json.loads(json.dumps(trace_to_dict(trace))))


def test_default_ssd_is_field_for_field_the_reference():
    assert dataclasses.asdict(DEFAULT_SSD) == dataclasses.asdict(REPRO_SSD)


@pytest.mark.parametrize("make", [
    lambda: synth_trace(_golden.MIXED),
    lambda: synth_trace(_golden.MIXED, n_arrays=6, pages_per_array=4),
    lambda: repro_get_trace("jacobi1d", "tiny"),
], ids=["synth", "synth_pressure", "jacobi1d_tiny"])
def test_trace_dict_round_trip(make):
    src = make()
    d = trace_to_dict(src)
    assert json.loads(json.dumps(d)) == d          # plain data only
    back = trace_from_dict(d)
    assert trace_to_dict(back) == d
    assert ([dataclasses.astuple(i) for i in back.instrs]
            == [dataclasses.astuple(i) for i in src.instrs])
    assert back.input_pages == src.input_pages
    assert back.output_pages == src.output_pages


def test_round_trip_keeps_allocation_state():
    pt = carry(synth_trace(_golden.MIXED)).pages
    ref = synth_trace(_golden.MIXED).pages
    assert pt.alloc_array(3 * DEFAULT_SSD.page_size, "x") == ref.alloc_array(
        3 * DEFAULT_SSD.page_size, "x")
    assert [(e.flash_block, e.channel, e.die) for e in pt.entries.values()] \
        == [(e.flash_block, e.channel, e.die) for e in ref.entries.values()]


def test_from_dict_rejects_another_page_size():
    d = trace_to_dict(synth_trace([1, 2]))
    d["page_size"] = 4096
    with pytest.raises(ValueError, match="4096"):
        trace_from_dict(d)


@pytest.mark.parametrize("policy", _golden.GOLDEN_POLICIES)
def test_carried_synth_trace_reproduces_golden_digest(policy):
    r = simulate(carry(synth_trace(_golden.MIXED)), policy)
    assert _golden.digest_sim(r) == GOLDEN[f"single/{policy}"]


def test_carried_pressure_fault_trace_reproduces_golden_digest():
    tr = carry(synth_trace(_golden.MIXED, n_arrays=6, pages_per_array=4))
    cfg = SimConfig(dram_capacity_pages=32, host_capacity_pages=48,
                    fail_rate=0.05)
    r = simulate(tr, "conduit", config=cfg)
    assert _golden.digest_sim(r) == GOLDEN["pressure_fault"]


@pytest.mark.parametrize("policy", POLICIES)
def test_carried_jacobi1d_trace_matches_repro_simulate(policy):
    tr = repro_get_trace("jacobi1d", "tiny")
    want = _golden.digest_sim(repro_simulate(tr, policy))
    assert _golden.digest_sim(simulate(carry(tr), policy)) == want


def test_analysis_waits_for_its_slice():
    from repro_torch.sim.stats import MixResult
    res = MixResult.__new__(MixResult)
    res.telemetry = object()
    with pytest.raises(NotImplementedError, match="analysis"):
        res.analysis()
