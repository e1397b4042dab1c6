"""The port's examples (``python -m repro_torch.examples.<name>``) print
what the JAX package's examples print, line for line.  Each runs as a
fresh process would: the trace caches of both packages are cleared first,
and the working directory is a scratch one, since three of them write a
trace file there."""
import pathlib
import runpy
import sys

import pytest

torch = pytest.importorskip("torch")

from repro import workloads as repro_workloads  # noqa: E402
from repro_torch import workloads  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ["multi_tenant_ndp", "gc_interference", "ndp_offload_demo",
            "open_loop_serving", "gc_policies", "tracing_walkthrough",
            "fleet_serving", "fault_injection"]
# the examples with a CI-sized mode
SMOKE = {"tracing_walkthrough", "fleet_serving", "fault_injection"}


def _run(argv, run, monkeypatch, capsys):
    repro_workloads.get_trace.cache_clear()
    workloads._trace.cache_clear()
    monkeypatch.setattr(sys, "argv", argv)
    capsys.readouterr()
    run()
    return capsys.readouterr().out


@pytest.mark.filterwarnings("ignore")
@pytest.mark.parametrize("name", EXAMPLES)
def test_example_prints_what_the_reference_prints(name, tmp_path,
                                                  monkeypatch, capsys):
    smoke = ["--smoke"] if name in SMOKE else []
    monkeypatch.chdir(tmp_path)
    want = _run([name] + smoke, lambda: runpy.run_path(
        str(ROOT / "examples" / f"{name}.py"), run_name="__main__"),
        monkeypatch, capsys)
    files = {p.name: p.read_bytes() for p in tmp_path.iterdir()}
    for p in tmp_path.iterdir():
        p.unlink()
    got = _run([name, "--device", "cpu"] + smoke, lambda: runpy.run_module(
        f"repro_torch.examples.{name}", run_name="__main__",
        alter_sys=True), monkeypatch, capsys)
    assert got.splitlines() == want.splitlines()
    assert len(got.splitlines()) > 5
    # the trace file an example writes is the reference's, byte for byte
    assert {p.name: p.read_bytes() for p in tmp_path.iterdir()} == files


def test_every_ported_example_is_a_module_of_the_package():
    pkg = ROOT / "src" / "repro_torch" / "examples"
    assert sorted(p.stem for p in pkg.glob("*.py")
                  if p.stem != "__init__") == sorted(EXAMPLES)
    assert all((ROOT / "examples" / f"{n}.py").is_file() for n in EXAMPLES)
