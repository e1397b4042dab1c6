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


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(PORT)) for p in PORT_FILES])
def test_no_jax_or_repro_import_in_source(path):
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


@pytest.mark.parametrize("entry", ["get_trace", "run_numeric", "make_inputs"])
def test_entry_points_without_device_need_a_gpu(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    from repro_torch import workloads
    args = {"get_trace": ("jacobi1d", "tiny"),
            "run_numeric": ("jacobi1d", "tiny"),
            "make_inputs": ("jacobi1d", "tiny")}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(workloads, entry)(*args)


def test_cpu_is_given_only_when_asked():
    from repro_torch import workloads
    a, b = workloads.make_inputs("jacobi1d", "tiny", device="cpu")
    assert a.device.type == "cpu" and b.device.type == "cpu"
    assert workloads.resolve_device("cpu") == torch.device("cpu")
