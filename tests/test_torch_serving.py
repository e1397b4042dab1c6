"""The port's open-loop serving (``sim/{workgen,serving,drive,sweep}.py``
and the ``stats.py`` results they fill) against the JAX package's: the
modules as textual copies of the reference that differ only in import
paths (``sweep.array_backend`` is the one function that differs), and
serving runs and saturation searches on traces the port makes itself,
equal field by field to the same runs on the reference's traces."""
import ast
import pathlib
import re
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _golden  # noqa: E402
from _synth import synth_trace  # noqa: E402
from test_torch_engine import carry  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from chip_smoke import plain  # noqa: E402
from repro import sim as repro_sim  # noqa: E402
from repro.workloads import get_trace as repro_get_trace  # noqa: E402
from repro_torch import sim  # noqa: E402
from repro_torch.sim import sweep  # noqa: E402
from repro_torch.workloads import get_trace  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
COPIED = ["workgen", "serving", "drive", "analysis", "placement", "fleet",
          "sweep", "stats"]
SHORT = [2, 4, 6] * 3

pytestmark = pytest.mark.filterwarnings("ignore:little_law_ratio")


def _without_array_backend(text):
    """``sweep.py``'s lines less ``array_backend``: its definition and the
    module docstring's bullet on it."""
    lines = text.splitlines()
    fn, = [n for n in ast.parse(text).body
           if isinstance(n, ast.FunctionDef) and n.name == "array_backend"]
    drop = set(range(fn.lineno - 1, fn.end_lineno))
    start = next(i for i, ln in enumerate(lines)
                 if ln.startswith("* :func:`array_backend`"))
    end = next(i for i in range(start + 1, len(lines))
               if lines[i].startswith("* "))
    drop |= set(range(start, end))
    return [ln for i, ln in enumerate(lines) if i not in drop]


@pytest.mark.parametrize("module", COPIED)
def test_module_is_the_reference_but_for_import_paths(module):
    ref = (SRC / "repro" / "sim" / f"{module}.py").read_text()
    port = (SRC / "repro_torch" / "sim" / f"{module}.py").read_text()
    if module == "sweep":
        ref, port = _without_array_backend(ref), _without_array_backend(port)
    else:
        ref, port = ref.splitlines(), port.splitlines()
    assert len(port) == len(ref)
    for a, b in zip(ref, port):
        a = a.replace("repro.core.vectorize import Trace",
                      "repro.core.trace import Trace")
        assert re.sub(r"\brepro\.", "repro_torch.", a) == b


def test_sweep_backend_is_numpy_in_double():
    """The bisection's array module: numpy, IEEE double, no jax."""
    xp = sweep.array_backend()
    assert xp is np
    assert xp.asarray([0.5]).dtype == np.float64


def test_exports_are_the_references():
    assert sim.__all__ == repro_sim.__all__
    assert all(hasattr(sim, name) for name in sim.__all__)


def test_no_stub_is_left_in_the_simulator():
    """The port raises NotImplementedError only where the reference does
    (an abstract base class's method)."""
    for path in (SRC / "repro_torch" / "sim").glob("*.py"):
        ref = SRC / "repro" / "sim" / path.name
        assert (path.read_text().count("NotImplementedError")
                == ref.read_text().count("NotImplementedError")), path.name


# -- runs through either package ----------------------------------------------

def catalog(mod, traces, names=("A", "B")):
    return mod.SessionCatalog(
        [mod.CatalogEntry(names[0], traces[0], weight=3.0),
         mod.CatalogEntry(names[1], traces[1], weight=1.0)], seed=5)


def synth_pair():
    return (synth_trace(_golden.RAMP, name="A"),
            synth_trace(SHORT, name="B"))


def workload_pair(port: bool):
    names = ("jacobi1d", "xor_filter")
    if port:
        return tuple(get_trace(n, "tiny", device="cpu") for n in names)
    return tuple(repro_get_trace(n, "tiny") for n in names)


ARRIVALS = {
    "poisson": lambda m: m.PoissonArrivals(rate_per_sec=6000, n_sessions=24,
                                           seed=9),
    "mmpp": lambda m: m.MMPPArrivals(rate_on_per_sec=16_000, mean_on_ns=2e6,
                                     mean_off_ns=2e6, n_sessions=24, seed=9),
    "deterministic": lambda m: m.DeterministicArrivals(rate_per_sec=5000,
                                                       n_sessions=24),
    "replay": lambda m: m.TraceReplayArrivals(
        times_ns=(0.0, 1e5, 1e5, 4e5, 9e5, 9e5, 2e6)),
    "superposed": lambda m: m.SuperposedArrivals(
        (m.PoissonArrivals(rate_per_sec=1000, n_sessions=16, seed=1),
         m.DeterministicArrivals(rate_per_sec=500, n_sessions=8))),
}


def drive_kw(mod, drive):
    """The drive a run serves on: idealised, with a garbage-collected FTL
    under host I/O, or with the error model armed on top of that."""
    if drive == "plain":
        return {}
    ftl = mod.FTLConfig(blocks_per_die=4, pages_per_block=8, op_ratio=0.28,
                        prefill=0.9, gc_suspend=True, gc_reserve_blocks=1)
    kw = dict(ftl=ftl, io_stream=mod.HostIOStream(
        rate_iops=60_000, read_fraction=0.5, n_requests=128,
        zipf_theta=0.95, n_logical_pages=ftl.logical_pages()))
    if drive == "faults":
        kw["faults"] = mod.FaultConfig(rber_base=1.2e-3,
                                       die_failures=((3, 2.0e5),))
    return kw


def serve(mod, traces, arrivals="poisson", drive="plain", policy="conduit",
          **kw):
    return mod.simulate_serving(catalog(mod, traces), ARRIVALS[arrivals](mod),
                                policy, **drive_kw(mod, drive), **kw)


@pytest.mark.parametrize("drive", ["plain", "ftl", "faults"])
@pytest.mark.parametrize("arrivals", sorted(ARRIVALS))
def test_serving_on_carried_traces_equals_reference(arrivals, drive):
    a, b = synth_pair()
    want = serve(repro_sim, (a, b), arrivals, drive)
    got = serve(sim, (carry(a), carry(b)), arrivals, drive)
    assert plain(got) == plain(want)


@pytest.mark.parametrize("drive", ["plain", "ftl", "faults"])
@pytest.mark.parametrize("policy", ["conduit", "bw", "dm"])
def test_serving_on_port_made_traces_equals_reference_made(policy, drive):
    want = serve(repro_sim, workload_pair(False), drive=drive, policy=policy)
    got = serve(sim, workload_pair(True), drive=drive, policy=policy)
    assert plain(got) == plain(want)
    assert got.n_completed > 0


@pytest.mark.parametrize("serving", [
    dict(max_active_sessions=1, max_backlog=2),
    dict(record_decisions=False, keep_session_results=False),
    dict(session_timeout_ns=2e5, warmup_ns=1e5, cooldown_ns=1e5),
], ids=["backlog", "lean", "timeouts"])
def test_serving_config_is_held_alike(serving):
    a, b = synth_pair()
    want = serve(repro_sim, (a, b), serving=repro_sim.ServingConfig(
        **serving))
    got = serve(sim, (carry(a), carry(b)), serving=sim.ServingConfig(
        **serving))
    assert plain(got) == plain(want)


def test_catalog_overrides_are_held_alike():
    """A kind's own policy and timeout override the run's."""
    a, b = synth_pair()

    def run(mod, traces):
        cat = mod.SessionCatalog(
            [mod.CatalogEntry("A", traces[0], weight=3.0),
             mod.CatalogEntry("B", traces[1], policy="isp",
                              timeout_ns=3e5)], seed=5)
        return mod.simulate_serving(cat, ARRIVALS["poisson"](mod), "bw")

    got = run(sim, (carry(a), carry(b)))
    assert plain(got) == plain(run(repro_sim, (a, b)))


def test_serving_with_telemetry_records_the_references_trace():
    a, b = synth_pair()
    tele = dict(spans=True, audit=True, interval_ns=20_000.0)
    want = serve(repro_sim, (a, b), drive="ftl",
                 telemetry=repro_sim.TelemetryConfig(**tele))
    got = serve(sim, (carry(a), carry(b)), drive="ftl",
                telemetry=sim.TelemetryConfig(**tele))
    assert got.telemetry.chrome_trace() == want.telemetry.chrome_trace()
    assert plain(got) == plain(want)


def test_catalog_draws_and_arrivals_are_the_references():
    a, b = synth_pair()
    want = catalog(repro_sim, (a, b))
    got = catalog(sim, (carry(a), carry(b)))
    assert ([got.draw(i).name for i in range(64)]
            == [want.draw(i).name for i in range(64)])
    assert got.kind_counts(64) == want.kind_counts(64)
    for kind, make in ARRIVALS.items():
        assert (make(sim).arrival_times_ns()
                == make(repro_sim).arrival_times_ns()), kind
        assert (make(sim).at_rate(3000).arrival_times_ns()
                == make(repro_sim).at_rate(3000).arrival_times_ns()), kind


def test_batched_arrival_grid_is_the_references():
    rates = [1000.0, 2500.0, 7000.0]
    got = sim.batched_poisson_arrival_times_ns(rates, 32, seed=9)
    want = repro_sim.batched_poisson_arrival_times_ns(rates, 32, seed=9)
    assert np.array_equal(np.asarray(got), np.asarray(want))


# -- saturation, scalar and batched -------------------------------------------

SEARCH = dict(rate_lo=1000.0, rate_hi=24_000.0, iters=4, n_sessions=24,
              seed=9)
# a p99 SLO between each drive's p99 at rate_lo and at rate_hi, so that
# every search bisects
SLO_NS = {"plain": 1.5e6, "ftl": 7.5e6, "faults": 7.5e6}


def _quiet(mod):
    return mod.ServingConfig(little_law_warn_tol=float("inf"))


@pytest.mark.parametrize("drive", ["plain", "ftl", "faults"])
@pytest.mark.parametrize("policy", ["conduit", "bw", "dm"])
def test_find_saturation_on_port_made_traces_equals_reference(policy,
                                                              drive):
    want = repro_sim.find_saturation(
        catalog(repro_sim, workload_pair(False)), policy, SLO_NS[drive],
        serving=_quiet(repro_sim), **drive_kw(repro_sim, drive), **SEARCH)
    got = sim.find_saturation(
        catalog(sim, workload_pair(True)), policy, SLO_NS[drive],
        serving=_quiet(sim), **drive_kw(sim, drive), **SEARCH)
    assert plain(got) == plain(want)
    assert len(got.probes) == 2 + SEARCH["iters"]


def test_find_saturation_over_an_mmpp_base_equals_reference():
    a, b = synth_pair()
    kw = dict(SEARCH, n_sessions=16, slo_p99_ns=SLO_NS["plain"])
    want = repro_sim.find_saturation(
        catalog(repro_sim, (a, b)), "conduit",
        base_process=ARRIVALS["mmpp"](repro_sim),
        serving=_quiet(repro_sim), **kw)
    got = sim.find_saturation(
        catalog(sim, (carry(a), carry(b))), "conduit",
        base_process=ARRIVALS["mmpp"](sim), serving=_quiet(sim), **kw)
    assert plain(got) == plain(want)


@pytest.mark.parametrize("drive", ["plain", "ftl"])
def test_batched_find_saturation_equals_reference_and_scalar(drive):
    """The sweep's law held across packages: the port's lockstep search
    equals the reference's and the port's own scalar searches."""
    search = {k: v for k, v in SEARCH.items()
              if k not in ("n_sessions", "seed")}
    search["slo_p99_ns"] = SLO_NS[drive]
    lanes = [("conduit", 9), ("bw", 9), ("dm", 9), ("conduit", 3)]

    def run(mod, traces):
        return mod.batched_find_saturation(
            catalog(mod, traces),
            [mod.SweepLane(policy=p, seed=s, n_sessions=16)
             for p, s in lanes],
            serving=_quiet(mod), **drive_kw(mod, drive), **search)

    want = run(repro_sim, workload_pair(False))
    got = run(sim, workload_pair(True))
    assert plain(got) == plain(want)
    scalar = [sim.find_saturation(
        catalog(sim, workload_pair(True)), p, n_sessions=16, seed=s,
        serving=_quiet(sim), **drive_kw(sim, drive), **search)
        for p, s in lanes]
    assert plain(got) == plain(scalar)


# -- the results' analysis() --------------------------------------------------

def test_serving_result_analysis_is_the_references_report():
    a, b = synth_pair()
    tele = dict(spans=True, audit=True, interval_ns=20_000.0)
    want = serve(repro_sim, (a, b), drive="faults",
                 telemetry=repro_sim.TelemetryConfig(**tele))
    got = serve(sim, (carry(a), carry(b)), drive="faults",
                telemetry=sim.TelemetryConfig(**tele))
    report = got.analysis(git_sha="fixed")
    assert report == want.analysis(git_sha="fixed")
    assert report["schema"] == "conduit-analysis/v1"


def test_mix_result_analysis_is_the_references_report():
    ref = [repro_get_trace(n, "tiny") for n in ("jacobi1d", "heat3d")]
    port = [get_trace(n, "tiny", device="cpu") for n in ("jacobi1d",
                                                          "heat3d")]

    def run(mod, traces):
        ftl = mod.FTLConfig(blocks_per_die=4, pages_per_block=8, prefill=0.9,
                            op_ratio=0.28)
        io = mod.HostIOStream(rate_iops=250_000, read_fraction=0.3,
                              n_requests=160, zipf_theta=0.95,
                              n_logical_pages=ftl.logical_pages())
        return mod.simulate_mix(traces, "conduit", io_stream=io, ftl=ftl,
                                compute_solo=False,
                                telemetry=mod.TelemetryConfig(
                                    spans=True, audit=True))

    report = run(sim, port).analysis(git_sha="fixed")
    assert report == run(repro_sim, ref).analysis(git_sha="fixed")
    assert report["sessions"]["n"] == 2


def test_analysis_without_a_recorder_raises_as_the_reference_does():
    a, b = synth_pair()
    for mod, traces in ((repro_sim, (a, b)), (sim, (carry(a), carry(b)))):
        with pytest.raises(ValueError, match="telemetry"):
            serve(mod, traces).analysis()


def test_serving_warns_as_the_reference_does():
    """Little's-law consistency warnings fire alike (a burst in a short
    window breaks L = lambda W beyond the default tolerance)."""
    a, b = synth_pair()
    caught = {}
    for name, mod, traces in (("ref", repro_sim, (a, b)),
                              ("port", sim, (carry(a), carry(b)))):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            serve(mod, traces, "replay",
                  serving=mod.ServingConfig(warmup_ns=2e5, cooldown_ns=2e5))
        caught[name] = [str(x.message) for x in w
                        if "little_law_ratio" in str(x.message)]
    assert caught["port"] == caught["ref"]
    assert len(caught["port"]) == 1
