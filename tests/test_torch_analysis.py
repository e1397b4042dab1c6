"""The port's trace analysis (``sim/analysis.py``) against the JAX
package's: on runs recorded by each package (serving under GC, with the
error model armed, a multi-tenant mix, a fleet), the port's reports,
blame rows, critical paths, pool rankings, diffs, fleet blame and stories
equal the reference's on its own recording, and ``python -m
repro_torch.sim.analysis`` prints what the reference's CLI prints and
exits with its codes."""
import io
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from test_torch_engine import carry  # noqa: E402
from test_torch_fleet import run_fleet  # noqa: E402
from test_torch_serving import (catalog, drive_kw, synth_pair,  # noqa: E402
                                workload_pair)

from repro import sim as repro_sim  # noqa: E402
from repro.sim import analysis as repro_analysis  # noqa: E402
from repro_torch import sim  # noqa: E402
from repro_torch.sim import analysis  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
FULL = dict(spans=True, audit=True, interval_ns=20_000.0)


def _serving(mod, traces, drive, policy="conduit"):
    return mod.simulate_serving(
        catalog(mod, traces),
        mod.PoissonArrivals(rate_per_sec=6000, n_sessions=12, seed=9),
        policy,
        serving=mod.ServingConfig(keep_session_results=False,
                                  warmup_ns=1e5, cooldown_ns=1e5,
                                  little_law_warn_tol=float("inf")),
        telemetry=mod.TelemetryConfig(**FULL), **drive_kw(mod, drive))


def _mix(mod, traces):
    ftl = mod.FTLConfig(blocks_per_die=4, pages_per_block=8, op_ratio=0.28,
                        prefill=0.9, gc_reserve_blocks=1)
    io_ = mod.HostIOStream(rate_iops=250_000, read_fraction=0.3,
                           n_requests=160, zipf_theta=0.95,
                           n_logical_pages=ftl.logical_pages())
    return mod.simulate_mix(list(traces), "conduit", io_stream=io_, ftl=ftl,
                            compute_solo=False,
                            telemetry=mod.TelemetryConfig(**FULL))


def _record(mod, port, which):
    """``which``'s chrome trace, recorded through ``mod`` on the port's
    traces (``port``) or the reference's."""
    if which.startswith("workload"):
        traces = workload_pair(port)
    else:
        a, b = synth_pair()
        traces = (carry(a), carry(b)) if port else (a, b)
    if which == "mix":
        return _mix(mod, traces).telemetry.chrome_trace()
    drive = {"serving_gc": "ftl", "faulted": "faults",
             "workload_bw": "plain"}.get(which, "ftl")
    policy = "bw" if which == "workload_bw" else "conduit"
    return _serving(mod, traces, drive, policy).telemetry.chrome_trace()


RUNS = ["serving_gc", "faulted", "mix", "workload_gc", "workload_bw"]


@pytest.fixture(scope="module")
def traces():
    """Each run as recorded by each package: ``{which: (port, ref)}``."""
    return {w: (_record(sim, True, w), _record(repro_sim, False, w))
            for w in RUNS}


@pytest.mark.parametrize("which", RUNS)
def test_recorded_traces_are_the_references(which, traces):
    got, want = traces[which]
    assert got == want


@pytest.mark.parametrize("fn", ["session_blame", "critical_path",
                                "pool_rankings"])
@pytest.mark.parametrize("which", RUNS)
def test_analysis_products_are_the_references(which, fn, traces):
    got, want = traces[which]
    assert (getattr(analysis, fn)(got)
            == getattr(repro_analysis, fn)(want))


@pytest.mark.parametrize("which", RUNS)
def test_report_and_story_are_the_references(which, traces):
    got, want = traces[which]
    report = analysis.build_report(got, git_sha="fixed")
    assert report == repro_analysis.build_report(want, git_sha="fixed")
    assert (analysis.blame_story(report)
            == repro_analysis.blame_story(
                repro_analysis.build_report(want, git_sha="fixed")))
    assert json.loads(json.dumps(report)) == report


@pytest.mark.parametrize("pair,tol", [
    (("serving_gc", "faulted"), None),
    (("serving_gc", "faulted"), 0.05),
    (("workload_gc", "workload_bw"), 0.05),     # refused: policy
    (("serving_gc", "mix"), None),              # refused: entry
])
def test_diff_reports_are_the_references(pair, tol, traces):
    a, b = pair
    got = analysis.diff_reports(
        analysis.build_report(traces[a][0], git_sha="fixed"),
        analysis.build_report(traces[b][0], git_sha="fixed"), tol_rel=tol)
    want = repro_analysis.diff_reports(
        repro_analysis.build_report(traces[a][1], git_sha="fixed"),
        repro_analysis.build_report(traces[b][1], git_sha="fixed"),
        tol_rel=tol)
    assert got == want


@pytest.fixture(scope="module")
def fleet_traces():
    a, b = synth_pair()
    got = run_fleet(sim, (carry(a), carry(b)), "hedging", n=18,
                    telemetry=True)
    want = run_fleet(repro_sim, (a, b), "hedging", n=18, telemetry=True)
    return (sim.merge_fleet_trace(got.telemetry),
            repro_sim.merge_fleet_trace(want.telemetry))


def test_fleet_blame_is_the_references(fleet_traces):
    got, want = fleet_traces
    blame = analysis.fleet_blame(got)
    assert blame == repro_analysis.fleet_blame(want)
    assert blame["schema"] == "conduit-fleet-analysis/v1"
    assert blame["straggler"]["drive"] == 0


def test_split_fleet_trace_is_the_references(fleet_traces):
    got, want = fleet_traces
    split = analysis.split_fleet_trace(json.loads(json.dumps(got)))
    assert split == repro_analysis.split_fleet_trace(want)
    assert sorted(split) == [0, 1, 2]
    for k, t in split.items():
        assert sim.validate_trace(t) == [], k


# -- the CLI ------------------------------------------------------------------

@pytest.fixture(scope="module")
def files(traces, tmp_path_factory):
    """Trace and report files the CLI reads, written from the reference's
    recordings (the port's are equal)."""
    d = tmp_path_factory.mktemp("analysis")
    out = {}
    for which in ("serving_gc", "faulted", "workload_bw"):
        p = d / f"{which}.json"
        p.write_text(json.dumps(traces[which][1]))
        out[which] = str(p)
        r = d / f"{which}.report.json"
        r.write_text(json.dumps(repro_analysis.build_report(
            traces[which][1], git_sha="fixed")))
        out[f"{which}_report"] = str(r)
    bad = json.loads(json.dumps(traces["serving_gc"][1]))
    del bad["otherData"]["schema"]
    (d / "bad.json").write_text(json.dumps(bad))
    out["bad"] = str(d / "bad.json")
    moved = repro_analysis.build_report(traces["serving_gc"][1],
                                        git_sha="fixed")
    moved["sessions"]["p99_ns"] *= 1.5
    (d / "moved.json").write_text(json.dumps(moved))
    out["moved"] = str(d / "moved.json")
    (d / "garbage.json").write_text("{not json")
    out["garbage"] = str(d / "garbage.json")
    out["missing"] = str(d / "missing.json")
    out["dir"] = str(d)
    return out


CLI_CASES = {
    "report": (["report", "{serving_gc}"], 0),
    "report_json_out": (["report", "{faulted}", "--json", "--out",
                         "{dir}/out.json"], 0),
    "report_missing": (["report", "{missing}"], 2),
    "report_invalid": (["report", "{bad}"], 1),
    "diff_traces": (["diff", "{serving_gc}", "{faulted}"], 0),
    "diff_reports_json": (["diff", "{serving_gc_report}",
                           "{faulted_report}", "--json"], 0),
    "diff_breach": (["diff", "{serving_gc_report}", "{moved}",
                     "--tol-rel", "0.1"], 1),
    "diff_refused": (["diff", "{serving_gc}", "{workload_bw}"], 2),
    "diff_forced": (["diff", "{serving_gc}", "{workload_bw}", "--force"],
                    0),
    "diff_garbage": (["diff", "{garbage}", "{garbage}"], 2),
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_output_and_exit_code_are_the_references(case, files):
    argv, code = CLI_CASES[case]
    argv = [a.format(**files) for a in argv]
    got, want = io.StringIO(), io.StringIO()
    assert repro_analysis.main(argv, out=want) == code
    if "--out" in argv:
        written = pathlib.Path(argv[-1]).read_text()
    assert analysis.main(argv, out=got) == code
    assert got.getvalue() == want.getvalue()
    if "--out" in argv:
        assert pathlib.Path(argv[-1]).read_text() == written


def test_cli_runs_as_a_module(files):
    """``python -m repro_torch.sim.analysis`` in its own process."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
    argv = ["diff", files["serving_gc_report"], files["moved"],
            "--tol-rel", "0.1"]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.sim.analysis", *argv], env=env,
        capture_output=True, text=True, timeout=120)
    want = io.StringIO()
    assert proc.returncode == repro_analysis.main(argv, out=want) == 1
    assert proc.stdout == want.getvalue()
