"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; each is a JSON file under this folder, and each per-layer metric is
a reader ``metrics/<name>.py`` with a function ``read(ctx)``.  A
configuration names its parameter layout and model-flop count, a module
``layouts/<name>.py``, and its plain reference ``reference/<name>.py``.
Adding a configuration, a mix or a metric is adding its files and its
entry.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
from types import ModuleType
from typing import Any, Dict, List

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: pathlib.Path = ROOT) -> Dict[str, Any]:
    return json.loads((root / "BENCHMARK.json").read_text())


def find(entries: List[dict], name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {what} named {name!r}; known: "
                   f"{[e['name'] for e in entries]}")


def read_json(path: pathlib.Path) -> Dict[str, Any]:
    return json.loads(path.read_text())


def config_of(bench: dict, cell: dict, root: pathlib.Path = ROOT) -> dict:
    """The configuration a cell names, from the file its entry gives."""
    entry = find(bench["configs"], cell["config"], "configuration")
    return read_json(root / entry["file"])


def traffic_of(cell: dict, here: pathlib.Path = HERE) -> dict:
    return read_json(here / "traffic" / f"{cell['traffic']}.json")


def limits_of(cell: dict, here: pathlib.Path = HERE) -> dict:
    return read_json(here / "limits" / f"{cell['name']}.json")


def load_module(path: pathlib.Path, name: str) -> ModuleType:
    """The Python file ``path`` as a module (names may hold dots, so it is
    loaded by path and not imported by name)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(name: str, here: pathlib.Path = HERE) -> ModuleType:
    return load_module(here / "metrics" / f"{name}.py",
                       f"cardbench_metric_{name.replace('.', '_')}")


def layout(config: dict, here: pathlib.Path = HERE) -> ModuleType:
    """The module ``layouts/<name>.py`` a configuration's ``layout`` key
    names (``lm`` without one): its parameter tree, ``layout(arch, init)``
    of ``(init, shape)`` leaves, and its counts, ``prefill_flops(arch,
    batch, seq)`` and ``k6_calls_per_prefill(arch)``."""
    name = config.get("layout", "lm")
    return load_module(here / "layouts" / f"{name}.py",
                       f"cardbench_layout_{name.replace('.', '_')}")


def reference(config: dict) -> ModuleType:
    """The plain reference ``reference/<name>.py`` a configuration names."""
    return importlib.import_module(f"cardbench.reference.{config['reference']}")


def end_to_end_of(bench: dict, cell: dict) -> List[dict]:
    """The cell's end-to-end metrics: those that list it, and those that
    list no cells."""
    return [m for m in bench["end_to_end"]
            if cell["name"] in m.get("workloads", [cell["name"]])]


def per_layer_of(bench: dict, cell: dict) -> List[dict]:
    """The cell's per-layer metrics: those that list it, and those that
    list no cells and move an end-to-end metric the cell reports."""
    reported = {m["name"] for m in end_to_end_of(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell["name"] in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]
