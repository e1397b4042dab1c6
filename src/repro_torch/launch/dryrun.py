"""Multi-pod dry-run: plan and count every (architecture x input shape)
cell on the production meshes and derive the roofline terms.

The counterpart of the JAX package's ``repro/launch/dryrun.py``, which
lowers and compiles each cell for 256 or 512 forced host devices.  Here a
cell runs once as a DTensor program on rank 0 of a fake process group of
the mesh's size (:func:`repro_torch.launch.mesh.fake_world`), its
arguments DTensors with fake local shards (:mod:`repro_torch.launch
.specs`), and :mod:`repro_torch.launch.costing` counts what that rank
runs.  Nothing is allocated beyond the program's small constants.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
      --shape train_4k --mesh both [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun.json

The mesh's device type is the GPU's (``cuda``) unless ``--device`` names
another; on a host without one pass ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from typing import Optional, Sequence, Tuple

from repro_torch import configs
from repro_torch.configs.shapes import (SHAPES, SHAPE_ORDER, ShapeSpec,
                                        applicable)
from repro_torch.device import resolve_device
from repro_torch.hw.gpu_spec import H100
from repro_torch.launch import costing
from repro_torch.launch.mesh import (fake_world, make_mesh, mesh_axes,
                                     production_shape)
from repro_torch.launch.specs import input_specs
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig


def model_flops(cfg: ArchConfig, kind: str, spec: ShapeSpec) -> int:
    """MODEL_FLOPS = 6 N D (train) or 2 N D (serving), N the active
    parameters, D the tokens (a decode step: one a sequence)."""
    if kind == "train":
        return 6 * cfg.active_param_count() * spec.global_batch * spec.seq_len
    if kind == "prefill":
        return 2 * cfg.active_param_count() * spec.global_batch * spec.seq_len
    return 2 * cfg.active_param_count() * spec.global_batch


def run_cell(arch: str, shape: str, multi_pod: bool = False, *,
             device=None,
             mesh: Optional[Tuple[Sequence[int], Sequence[str]]] = None,
             cfg: Optional[ArchConfig] = None,
             spec: Optional[ShapeSpec] = None) -> dict:
    """Plan and count one cell on rank 0 of a fake process group; returns
    its record.  ``mesh`` ((shape, axis names)) replaces the production
    mesh, ``cfg`` and ``spec`` the arch's config and the shape's sizes."""
    mesh_dims, axes = mesh or production_shape(multi_pod)
    cfg = cfg or configs.get(arch)
    spec = spec or SHAPES[shape]
    device_type = resolve_device(device).type
    chips = math.prod(mesh_dims)
    with fake_world(chips):
        dmesh = make_mesh(mesh_dims, axes, device_type)
        L.set_mesh_axes(*mesh_axes(dmesh))
        try:
            t0 = time.time()
            fn, args, kind = input_specs(arch, shape, dmesh, cfg, spec)
            t_specs = time.time() - t0
            steps = spec.seq_len if kind != "decode" else 1
            cost = costing.count_cell(cfg, fn, args, steps)
            t_count = time.time() - t0 - t_specs
        finally:
            L.set_mesh_axes((), None)

    rec = {
        "arch": arch, "shape": shape, "kind": kind,
        "mesh": "x".join(str(d) for d in mesh_dims),
        "chips": chips,
        "specs_s": round(t_specs, 1), "count_s": round(t_count, 1),
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
        "argument_size_in_bytes": costing.argument_bytes(args),
        # per device
        "per_device_bytes": cost["peak_bytes"], "flops": cost["flops"],
        "op_bytes": cost["op_bytes"], "collectives": cost["collectives"],
    }
    if "scan_steps_counted" in cost:
        rec["scan_steps_counted"] = cost["scan_steps_counted"]
    # three-term per-device roofline: the counts are one rank's, so
    # chips=1 in the divisor
    rec["roofline"] = H100.roofline_terms(rec["flops"], rec["op_bytes"],
                                          rec["collectives"]["total"], 1)
    rec["model_flops"] = model_flops(cfg, kind, spec)      # global
    total_flops = rec["flops"] * chips
    rec["useful_flop_ratio"] = (rec["model_flops"] / total_flops
                                if total_flops else None)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi",
                                                       "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="the mesh's device type (default: the GPU)")
    args = ap.parse_args()

    archs = configs.ARCHS if args.arch == "all" or args.all else [args.arch]
    shapes = list(SHAPE_ORDER) if args.shape == "all" or args.all \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    records = []
    for arch in archs:
        cfg = configs.get(arch)
        for shape in shapes:
            ok, reason = applicable(cfg, shape)
            if not ok:
                records.append({"arch": arch, "shape": shape,
                                "skipped": reason})
                print(f"SKIP  {arch:22s} {shape:12s} {reason}")
                continue
            for multi in meshes:
                tag = "2x16x16" if multi else "16x16"
                try:
                    rec = run_cell(arch, shape, multi_pod=multi,
                                   device=args.device)
                    records.append(rec)
                    r = rec["roofline"]
                    print(f"OK    {arch:22s} {shape:12s} {tag:8s} "
                          f"flops={rec['flops']:.3e} "
                          f"coll={rec['collectives']['total']:.3e}B "
                          f"bound={r['dominant']:10s} "
                          f"[specs {rec['specs_s']}s count "
                          f"{rec['count_s']}s]")
                except Exception as e:
                    records.append({"arch": arch, "shape": shape,
                                    "mesh": tag, "error": str(e)})
                    print(f"FAIL  {arch:22s} {shape:12s} {tag:8s} {e}")
                    traceback.print_exc()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
        print(f"wrote {args.out} ({len(records)} records)")


if __name__ == "__main__":
    main()
