"""The port stands alone: ``repro_torch`` imports torch and numpy, never
jax and never the JAX package ``repro``; its entry points run on the GPU
unless the caller asks for the CPU."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

PORT = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py"))


def _module_name(path: pathlib.Path) -> str:
    rel = path.relative_to(PORT.parent).with_suffix("")
    parts = list(rel.parts)
    if parts[-1] == "__init__":
        parts.pop()
    return ".".join(parts)


def test_every_module_imports_without_jax_or_repro():
    names = [_module_name(p) for p in PORT_FILES]
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "assert 'jaxlib' not in sys.modules\n"
        "print(len(sys.modules))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(PORT.parent)] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _assert_no_jax_or_repro_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (
                f"{path.name}:{node.lineno} imports {mod}")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(PORT)) for p in PORT_FILES])
def test_no_jax_or_repro_import_in_source(path):
    _assert_no_jax_or_repro_import(path)


def test_models_and_kernels_import_nothing_of_the_launcher():
    """The launcher builds on the model and the kernels, never the other
    way round: no module under ``models/`` or ``kernels/`` imports
    ``repro_torch.launch``."""
    bad = []
    for path in PORT_FILES:
        if path.relative_to(PORT).parts[0] not in ("models", "kernels"):
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [f"{node.module}.{a.name}" for a in node.names]
            else:
                continue
            bad += [f"{path.relative_to(PORT)}:{node.lineno} {mod}"
                    for mod in mods
                    if (mod + ".").startswith("repro_torch.launch.")]
    assert not bad, bad


def test_chip_smoke_imports_no_jax_or_repro():
    """The smoke runs where jax is absent; it imports only the port."""
    _assert_no_jax_or_repro_import(PORT.parents[1] / "chip_smoke.py")


@pytest.mark.parametrize("entry", ["get_trace", "run_numeric", "make_inputs",
                                   "train"])
def test_entry_points_without_device_need_a_gpu(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    from repro_torch import workloads
    from repro_torch.launch import train
    fn, args = {"get_trace": (workloads.get_trace, ("jacobi1d", "tiny")),
                "run_numeric": (workloads.run_numeric, ("jacobi1d", "tiny")),
                "make_inputs": (workloads.make_inputs, ("jacobi1d", "tiny")),
                "train": (train.train, ("tinyllama-1.1b", 1, 1, 4))}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fn(*args)


def test_cpu_is_given_only_when_asked():
    from repro_torch import workloads
    a, b = workloads.make_inputs("jacobi1d", "tiny", device="cpu")
    assert a.device.type == "cpu" and b.device.type == "cpu"
    assert workloads.resolve_device("cpu") == torch.device("cpu")


def test_serve_without_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.serve("tinyllama-1.1b", 1, 1, 4, 1)


def test_lm_modules_are_covered():
    """The isolation scan reaches the LM slice's modules (the families'
    Mamba2/xLSTM blocks among them) and the kernel's CUDA source sits
    beside the others."""
    names = {_module_name(p) for p in PORT_FILES}
    assert {"repro_torch.models.model", "repro_torch.models.layers",
            "repro_torch.models.ssm",
            "repro_torch.models.config", "repro_torch.configs",
            "repro_torch.configs.tinyllama_1_1b", "repro_torch.launch.serve",
            "repro_torch.launch.steps", "repro_torch.kernels.attention"} \
        <= names
    assert (PORT / "kernels" / "csrc" / "attention.cu").is_file()


def test_open_loop_modules_and_examples_are_covered():
    """The isolation scan reaches the serving, fleet and analysis slice
    and every example of the package."""
    names = {_module_name(p) for p in PORT_FILES}
    sim_modules = {f"repro_torch.sim.{m}" for m in (
        "workgen", "serving", "drive", "analysis", "placement", "fleet",
        "sweep", "stats")}
    examples = {f"repro_torch.examples.{m}" for m in (
        "multi_tenant_ndp", "gc_interference", "ndp_offload_demo",
        "open_loop_serving", "gc_policies", "tracing_walkthrough",
        "fleet_serving", "fault_injection", "quickstart", "serve_batched",
        "train_tinylm")}
    assert sim_modules | examples | {"repro_torch.examples"} <= names


def test_training_modules_are_covered():
    """The isolation scan reaches the training slice's modules."""
    names = {_module_name(p) for p in PORT_FILES}
    assert {f"repro_torch.{m}" for m in (
        "optim", "optim.adamw", "optim.schedule", "optim.compress", "data",
        "data.pipeline", "checkpoint", "checkpoint.manager",
        "launch.elastic", "launch.train", "launch.steps")} <= names


def test_example_without_device_needs_a_gpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    from repro_torch.examples import multi_tenant_ndp
    monkeypatch.setattr(sys, "argv", ["multi_tenant_ndp"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multi_tenant_ndp.main()
