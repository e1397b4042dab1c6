"""The port's fleets (``sim/{placement,fleet}.py`` and the fleet half of
``sim/sweep.py``) against the JAX package's: fleet runs, fleet saturation
searches (scalar and batched) and placements, on traces the port makes
itself and on traces carried across as plain data, equal field by field to
the same runs on the reference's traces."""
import pathlib
import sys

import pytest

torch = pytest.importorskip("torch")

from test_torch_engine import carry  # noqa: E402
from test_torch_serving import (catalog, drive_kw, synth_pair,  # noqa: E402
                                workload_pair)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from chip_smoke import plain  # noqa: E402
from repro import sim as repro_sim  # noqa: E402
from repro.sim.drive import DriveHealth as RefDriveHealth  # noqa: E402
from repro_torch import sim  # noqa: E402
from repro_torch.sim.drive import DriveHealth  # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore:little_law_ratio")


def quiet(mod):
    return mod.ServingConfig(little_law_warn_tol=float("inf"))


def arrivals(mod, rate=6000, n=24, seed=9):
    return mod.PoissonArrivals(rate_per_sec=rate, n_sessions=n, seed=seed)


def straggler(mod, n_requests=300):
    """examples/fleet_serving.py's drive 0: write churn on a tight FTL."""
    ftl = mod.FTLConfig(blocks_per_die=4, pages_per_block=8, op_ratio=0.28,
                        prefill=0.9, gc_suspend=True, gc_reserve_blocks=1)
    io = mod.HostIOStream(rate_iops=150_000, read_fraction=0.1,
                          n_requests=n_requests, zipf_theta=0.9,
                          n_logical_pages=ftl.logical_pages(), seed=11)
    return mod.DriveProfile(io_stream=io, ftl=ftl)


FLEETS = {
    "hash": dict(n_drives=3),
    "consistent": dict(n_drives=3, placement="consistent", replication=2),
    "heat": dict(n_drives=3, placement="heat", replication=2),
    "steering": dict(n_drives=3, replication=2, steering=True,
                     straggler=True),
    "hedging": dict(n_drives=3, replication=2, hedging=True,
                    straggler=True),
    "max_inflight": dict(n_drives=2, replication=2, max_inflight=1),
    "retire": dict(n_drives=3, replication=2, retire=(1, 3.0e6),
                   rebuild_read_iops=4_000.0, rebuild_reads=128),
}


def fleet_config(mod, name):
    kw = dict(FLEETS[name])
    if kw.pop("straggler", False):
        kw["profiles"] = ((0, straggler(mod)),)
    return mod.FleetConfig(**kw)


def run_fleet(mod, traces, name, rate=6000, n=24, drive="plain", **kw):
    return mod.simulate_fleet(catalog(mod, traces), arrivals(mod, rate, n),
                              "conduit", serving=quiet(mod),
                              fleet=fleet_config(mod, name),
                              **drive_kw(mod, drive), **kw)


@pytest.mark.parametrize("name", sorted(FLEETS))
def test_fleet_on_carried_traces_equals_reference(name):
    a, b = synth_pair()
    rate = 100_000 if name == "max_inflight" else 6000
    want = run_fleet(repro_sim, (a, b), name, rate)
    got = run_fleet(sim, (carry(a), carry(b)), name, rate)
    assert plain(got) == plain(want)
    assert got.n_inflight == 0


@pytest.mark.parametrize("drive", ["plain", "ftl", "faults"])
@pytest.mark.parametrize("name", ["hash", "hedging"])
def test_fleet_on_port_made_traces_equals_reference_made(name, drive):
    want = run_fleet(repro_sim, workload_pair(False), name, drive=drive)
    got = run_fleet(sim, workload_pair(True), name, drive=drive)
    assert plain(got) == plain(want)
    assert got.n_completed > 0


def test_fleet_with_recorders_merges_the_references_trace():
    a, b = synth_pair()
    want = run_fleet(repro_sim, (a, b), "hedging", n=18, telemetry=True)
    got = run_fleet(sim, (carry(a), carry(b)), "hedging", n=18,
                    telemetry=True)
    merged = sim.merge_fleet_trace(got.telemetry)
    assert merged == repro_sim.merge_fleet_trace(want.telemetry)
    assert sim.validate_trace(merged) == []
    assert plain(got) == plain(want)


# -- fleet saturation, scalar and batched -------------------------------------

SEARCH = dict(slo_p99_ns=2e6, rate_lo=500.0, rate_hi=40_000.0, iters=2)


@pytest.mark.parametrize("name", ["hash", "heat", "steering"])
def test_find_fleet_saturation_equals_reference(name):
    def run(mod, traces):
        return mod.find_fleet_saturation(
            catalog(mod, traces), arrivals(mod, rate=100), "conduit",
            serving=quiet(mod), fleet=fleet_config(mod, name), **SEARCH)

    want = run(repro_sim, workload_pair(False))
    got = run(sim, workload_pair(True))
    assert plain(got) == plain(want)


def test_batched_find_fleet_saturation_equals_reference_and_scalar():
    names = ["hash", "heat"]

    def lanes(mod):
        return [mod.FleetSweepLane("conduit", fleet=fleet_config(mod, n),
                                   seed=9, n_sessions=24) for n in names]

    def run(mod, traces):
        return mod.batched_find_fleet_saturation(
            catalog(mod, traces), lanes(mod), serving=quiet(mod), **SEARCH)

    got = run(sim, workload_pair(True))
    assert plain(got) == plain(run(repro_sim, workload_pair(False)))
    scalar = [sim.find_fleet_saturation(
        catalog(sim, workload_pair(True)), lane.base_process(
            SEARCH["rate_lo"]), "conduit", serving=quiet(sim),
        fleet=lane.fleet, **SEARCH) for lane in lanes(sim)]
    assert plain(got) == plain(scalar)


# -- placement ----------------------------------------------------------------

@pytest.mark.parametrize("cls", ["HashPlacement", "ConsistentHashPlacement",
                                 "HeatAwarePlacement"])
@pytest.mark.parametrize("n", [1, 4, 5])
def test_replica_sets_are_the_references(cls, n):
    got, want = getattr(sim, cls)(n), getattr(repro_sim, cls)(n)
    for r in (1, 2, 3):
        assert ([got.replicas(sid, r) for sid in range(200)]
                == [want.replicas(sid, r) for sid in range(200)])


def _health(mod_health, d, **kw):
    base = dict(drive_id=d, t_ns=0.0, active=0, backlog=0, gc_busy=False,
                gc_active_dies=0, read_only_dies=0, failed_dies=0,
                recovering=False, retired=False)
    base.update(kw)
    return mod_health(**base)


@pytest.mark.parametrize("state", [
    {0: dict(gc_busy=True, gc_active_dies=2), 2: dict(active=1)},
    {},
    {0: dict(retired=True), 1: dict(gc_busy=True), 2: dict(recovering=True)},
    {1: dict(backlog=3, failed_dies=1), 2: dict(read_only_dies=2)},
], ids=["gc", "ties", "retired", "degraded"])
def test_routes_are_the_references(state):
    def route(mod, health_cls, placement):
        health = {d: _health(health_cls, d, **state.get(d, {}))
                  for d in range(3)}
        p = mod.make_placement(placement, 3)
        return [p.route(sid, p.replicas(sid, 3), health)
                for sid in range(12)]

    for placement in ("hash", "consistent", "heat"):
        assert (route(sim, DriveHealth, placement)
                == route(repro_sim, RefDriveHealth, placement))


def test_drive_seeds_are_the_references():
    for seed in (0, 9, 12345, 0xA117):
        for d in range(6):
            for salt in (0, 1, 2):
                assert (sim.derive_drive_seed(seed, d, salt)
                        == repro_sim.derive_drive_seed(seed, d, salt))


@pytest.mark.parametrize("kw,match", [
    (dict(n_drives=3, hedging=True), "hedging needs replication"),
    (dict(n_drives=3, steering=True), "steering needs replication"),
    (dict(n_drives=2, replication=3), "replication"),
    (dict(n_drives=2, retire=(5, 1.0)), "retire"),
    (dict(n_drives=1, retire=(0, 1.0)), "only drive"),
])
def test_fleet_config_refuses_as_the_reference_does(kw, match):
    for mod in (repro_sim, sim):
        with pytest.raises(ValueError, match=match):
            mod.FleetConfig(**kw)
