"""The port's examples (``python -m repro_torch.examples.<name>``) print
what the JAX package's examples print, line for line.  Each runs as a
fresh process would: the trace caches of both packages are cleared first,
and the working directory is a scratch one, since three of them write a
trace file there.  The two LM examples draw other random weights than
the JAX package's and time themselves, so their lines are held equal with
the numbers that come from weights and clocks masked."""
import functools
import pathlib
import re
import runpy
import sys

import pytest

torch = pytest.importorskip("torch")

from repro import workloads as repro_workloads  # noqa: E402
from repro_torch import workloads  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ["multi_tenant_ndp", "gc_interference", "ndp_offload_demo",
            "open_loop_serving", "gc_policies", "tracing_walkthrough",
            "fleet_serving", "fault_injection", "quickstart",
            "serve_batched", "train_tinylm", "multipod_planning"]
# the LM examples: their losses, rates and times differ from the
# reference's (torch and jax.random draw other weights)
LM = {"serve_batched", "train_tinylm"}
# the examples with a CI-sized mode
SMOKE = {"tracing_walkthrough", "fleet_serving", "fault_injection"}
# the planning example: the H100's constants, where the reference's are a
# TPU's (held equal under the TPU's below)
PLANNING = {"multipod_planning"}


def _run(argv, run, monkeypatch, capsys):
    repro_workloads.get_trace.cache_clear()
    workloads._trace.cache_clear()
    monkeypatch.setattr(sys, "argv", argv)
    capsys.readouterr()
    run()
    return capsys.readouterr().out


@pytest.mark.filterwarnings("ignore")
@pytest.mark.parametrize("name", [n for n in EXAMPLES
                                  if n not in LM | PLANNING])
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


# a training run small enough for the CPU, in which the loss decreases
TINYLM = ["--steps", "25", "--d-model", "64", "--layers", "2", "--vocab",
          "256", "--batch", "8", "--seq", "16"]
# the numbers drawn from weights and clocks: losses, gradient norms,
# rates, latencies and step times
MASKED = {
    "serve_batched": [r"[\d.]+ tok/s", r"p50 \d+ms", r"p99 \d+ms"],
    "train_tinylm": [r"loss [\d.]+ -> [\d.]+", r"loss +[\d.]+",
                     r"gnorm +[\d.]+", r" +[\d.]+ms(  STRAGGLER)?$"]}


def _masked(name, out):
    lines = out.splitlines()
    for pattern in MASKED[name]:
        lines = [re.sub(pattern, "#", line) for line in lines]
    return lines


@pytest.mark.filterwarnings("ignore")
@pytest.mark.parametrize("name", sorted(LM))
def test_lm_example_prints_the_reference_lines(name, tmp_path, monkeypatch,
                                               capsys):
    """The same lines with the same request, token and step counts and
    learning rates; the port's tinylm loss decreases (the example asserts
    it, as the reference does).  torch runs on one thread, restored after:
    at these sizes threads do not pay, and beside other test processes
    they thrash."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _check_lm_example(name, tmp_path, monkeypatch, capsys)
    finally:
        torch.set_num_threads(threads)


def _check_lm_example(name, tmp_path, monkeypatch, capsys):
    args = {"serve_batched": [],
            "train_tinylm": TINYLM}[name]
    monkeypatch.chdir(tmp_path)
    want = _run([name] + args + ["--ckpt-dir", str(tmp_path / "ref")] * (
        name == "train_tinylm"), lambda: runpy.run_path(
        str(ROOT / "examples" / f"{name}.py"), run_name="__main__"),
        monkeypatch, capsys)
    got = _run([name, "--device", "cpu"] + args + [
        "--ckpt-dir", str(tmp_path / "port")] * (name == "train_tinylm"),
        lambda: runpy.run_module(f"repro_torch.examples.{name}",
                                 run_name="__main__", alter_sys=True),
        monkeypatch, capsys)
    assert _masked(name, got) == _masked(name, want)
    if name == "serve_batched":
        assert got.startswith("[serve] 12 requests, 144 tokens, ")
    else:
        first, final = map(float, re.search(
            r"loss ([\d.]+) -> ([\d.]+)", got).groups())
        assert final < first
        assert len(got.splitlines()) == 6     # params, steps 0, 10, 20, 24
    return got


@pytest.mark.filterwarnings("ignore")
def test_train_tinylm_mask_covers_a_straggler_flag(tmp_path, monkeypatch,
                                                   capsys):
    """A logged step slower than the straggler threshold ends its line
    with ``  STRAGGLER``; the wall clock decides which, so the mask covers
    the flag.  Forced here in the port alone (threshold 0: every step
    after the first five is flagged) and held equal to the reference's
    unflagged lines."""
    from repro_torch.launch import elastic, train
    monkeypatch.setattr(train, "StragglerMonitor", functools.partial(
        elastic.StragglerMonitor, threshold=0.0))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = _check_lm_example("train_tinylm", tmp_path, monkeypatch,
                                capsys)
    finally:
        torch.set_num_threads(threads)
    assert got.count("  STRAGGLER") == 3       # steps 10, 20 and 24


def test_multipod_planning_prints_the_reference_lines_under_its_constants(
        monkeypatch, capsys):
    """Given the JAX package's TPU constants, the port's planning example
    prints the reference example's lines; with the H100's (its default),
    the same plans in the same layout."""
    from repro.hw.tpu_spec import TPU_V5E
    from repro_torch.examples import multipod_planning
    from repro_torch.hw.gpu_spec import GPUSpec
    want = _run(["multipod_planning"], lambda: runpy.run_path(
        str(ROOT / "examples" / "multipod_planning.py"),
        run_name="__main__"), monkeypatch, capsys)
    tpu = GPUSpec(peak_bf16_flops=TPU_V5E.peak_bf16_flops,
                  hbm_bw=TPU_V5E.hbm_bw, hbm_bytes=TPU_V5E.hbm_bytes,
                  nic_bw=TPU_V5E.ici_bw)
    got = _run(["multipod_planning", "--device", "cpu"],
               lambda: multipod_planning.main(tpu), monkeypatch, capsys)
    assert got.splitlines() == want.splitlines()
    h100 = _run(["multipod_planning", "--device", "cpu"],
                multipod_planning.main, monkeypatch, capsys).splitlines()
    assert h100[:2] == want.splitlines()[:2] and len(h100) == 9
    assert sorted(line.split()[0] for line in h100[2:]) == sorted(
        line.split()[0] for line in want.splitlines()[2:])


def test_every_ported_example_is_a_module_of_the_package():
    pkg = ROOT / "src" / "repro_torch" / "examples"
    assert sorted(p.stem for p in pkg.glob("*.py")
                  if p.stem != "__init__") == sorted(EXAMPLES)
    assert all((ROOT / "examples" / f"{n}.py").is_file() for n in EXAMPLES)
