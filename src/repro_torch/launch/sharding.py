"""Sharding plans: parameter / optimizer / cache / batch specs.

The counterpart of the JAX package's ``repro/launch/sharding.py``.  The
baseline plan is name-rule-driven 2D sharding: tensor-parallel over
"model" (attention heads, FFN columns, expert dim, vocab-free embedding
feature dim) and FSDP-style weight sharding over "data" (+"pod").  Every
axis assignment is divisibility-checked against the mesh and dropped when
it does not divide (e.g. 2-head KV caches on a 16-way model axis shard the
sequence dimension instead).

A spec is a tuple with one entry per tensor dim, as a ``PartitionSpec``:
``None`` (replicated), an axis name, or a tuple of axis names (the dim
split over each in turn, the first outermost).  ``models/layers.py``
``placements`` turns it into DTensor placements, one per mesh dim.

The port keeps one dict per layer where the JAX package stacks its
segments on a leading layer axis.  A parameter rule indexes dims from the
end, so it gives the same entries with or without that axis; the cache
rules index the JAX package's stacked ``[L, B, ...]`` layout from the
front, and here read one dim lower (``[B, ...]``).
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from repro_torch.launch.mesh import mesh_axes
from repro_torch.models.layers import axis_size, fit_spec, placements

Spec = Tuple[Any, ...]
Path = Tuple[Any, ...]

# column-parallel leaves (shard last dim over "model", -2 over data/FSDP)
_COL = {"wq", "wk", "wv", "w1", "w3", "w_uq", "w_uk", "w_uv", "w_q",
        "w_in", "w_bc", "w_dt", "w_gates", "w_if", "r_gates", "w_dkv",
        "w_dq", "router"}
# row-parallel leaves (shard -2 over "model", last over data/FSDP)
_ROW = {"wo", "w2", "w_out"}


def _leaf_name(path: Path) -> str:
    for entry in reversed(path):
        if isinstance(entry, str):
            return entry
    return ""


def param_spec_for(path: Path, shape: Sequence[int], mesh: DeviceMesh,
                   data: Tuple[str, ...], model: Optional[str]) -> Spec:
    name = _leaf_name(path)
    nd = len(shape)
    dataspec = data if data else None
    if name in ("emb", "unemb"):
        if name == "emb":   # [V, D] -> feature dim over (data, model)
            combined = tuple(a for a in (data + ((model,) if model else ()))
                             if a)
            return fit_spec(mesh, shape, [None, combined or None])
        return fit_spec(mesh, shape,
                        [tuple(data + ((model,) if model else ())) or None,
                         None])
    if "experts" in path and nd >= 3:
        # [E, D, F] / [E, F, D]: expert-parallel over model, FSDP over the
        # contraction dim.
        spec = [None] * nd
        spec[nd - 3] = model
        spec[nd - 2] = dataspec
        return fit_spec(mesh, shape, spec)
    if name in _COL and nd >= 2:
        spec = [None] * nd
        spec[nd - 1] = model
        spec[nd - 2] = dataspec
        return fit_spec(mesh, shape, spec)
    if name in _ROW and nd >= 2:
        spec = [None] * nd
        spec[nd - 1] = dataspec
        spec[nd - 2] = model
        return fit_spec(mesh, shape, spec)
    if name in ("conv_w", "a_log", "d_skip") and nd >= 1:
        spec = [None] * nd
        spec[nd - 1] = model
        return fit_spec(mesh, shape, spec)
    return (None,) * nd   # norms and other small leaves: replicated


def cache_spec_for(path: Path, shape: Sequence[int], mesh: DeviceMesh,
                   data: Tuple[str, ...], model: Optional[str]) -> Spec:
    """One layer's cache or state leaf, ``[B, ...]``."""
    name = _leaf_name(path)
    nd = len(shape)
    dataspec = data if data else None
    spec: List[Any] = [None] * nd
    if name in ("k", "v"):            # [B, S, Hkv, dh]
        spec[0] = dataspec
        spec[1] = model               # sequence-sharded cache
    elif name in ("latent", "k_rope"):  # [B, S, r]
        spec[0] = dataspec
        spec[1] = model
    elif name == "h" and nd == 3:     # mamba state [B, di, N]
        spec[0] = dataspec
        spec[1] = model
    elif name == "conv":              # [B, K-1, di]
        spec[0] = dataspec
        spec[2] = model
    elif name in ("c", "n", "m", "hid"):
        spec[0] = dataspec
    elif nd >= 1:
        spec[0] = dataspec
    return fit_spec(mesh, shape, spec)


def batch_spec(shape: Sequence[int], mesh: DeviceMesh) -> Spec:
    """Token batches: batch dim over (pod, data)."""
    data, _ = mesh_axes(mesh)
    spec = [data if data else None] + [None] * (len(shape) - 1)
    return fit_spec(mesh, shape, spec)


def embeds_spec(shape: Sequence[int], mesh: DeviceMesh) -> Spec:
    data, model = mesh_axes(mesh)
    spec = [data if data else None] + [None] * (len(shape) - 2) + [model]
    return fit_spec(mesh, shape, spec)


def map_with_path(fn: Callable[[Path, Any], Any], tree, path: Path = ()):
    """``fn(path, leaf)`` over dicts, lists, tuples and NamedTuples; a
    path holds dict keys, field names and list indices."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def param_specs(params, mesh: DeviceMesh):
    """A spec for every leaf of a parameter tree (or of AdamW moments,
    whose paths end in the parameters' names); a 0-d leaf is replicated."""
    data, model = mesh_axes(mesh)
    return map_with_path(
        lambda path, leaf: param_spec_for(path, leaf.shape, mesh, data,
                                          model)
        if leaf.ndim > 0 else (), params)


def cache_specs(caches, mesh: DeviceMesh):
    data, model = mesh_axes(mesh)
    return map_with_path(
        lambda path, leaf: cache_spec_for(path, leaf.shape, mesh, data,
                                          model), caches)


def local_shape(shape: Sequence[int], spec: Spec,
                mesh: DeviceMesh) -> Tuple[int, ...]:
    """Each rank's shard of a ``shape`` tensor under a fitted ``spec``."""
    return tuple(dim // axis_size(mesh, entry)
                 for dim, entry in zip(shape, tuple(spec) + (None,) * (
                     len(shape) - len(spec))))


def sharded_like(t: torch.Tensor, spec: Spec, mesh: DeviceMesh) -> DTensor:
    """A DTensor of ``t``'s global shape and dtype laid out by ``spec``,
    whose local shard is a new uninitialised tensor of ``t``'s kind (a
    fake tensor under ``FakeTensorMode``: nothing is allocated)."""
    local = torch.empty(local_shape(t.shape, spec, mesh), dtype=t.dtype,
                        device=mesh.device_type)
    stride = torch.empty(t.shape, device="meta").stride()
    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              run_check=False, shape=t.shape, stride=stride)


def at_path(tree, path: Path):
    """The subtree of ``tree`` at ``path`` (as ``map_with_path`` names it)."""
    for key in path:
        tree = getattr(tree, key) if isinstance(key, str) and hasattr(
            tree, "_fields") else tree[key]
    return tree


def to_dtensors(tree, specs, mesh: DeviceMesh):
    """``sharded_like`` over a tree of tensors and its tree of specs."""
    return map_with_path(
        lambda path, t: sharded_like(t, at_path(specs, path), mesh), tree)
