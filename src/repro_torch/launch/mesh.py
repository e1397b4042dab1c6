"""Production mesh construction.

Functions, not module-level constants, so that importing this module never
touches process-group state.  Single pod: 16x16 = 256 ranks, axes (data,
model).  Multi-pod: 2 pods x 256 = 512 ranks, (pod, data, model): the
"pod" axis carries the data-parallel gradient reduction between pods.
The shapes and axis names are the JAX package's, so that every dry-run
cell is its cell; on H100s a 16-wide axis spans two 8-GPU NVLink nodes.

A mesh needs a process group of its size.  :func:`fake_world` makes one
on the fake backend (``torch.testing``'s ``FakeStore``): rank 0 of ``n``,
every collective a no-op, so that a 512-rank program can be planned and
counted on one host.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def production_shape(multi_pod: bool = False
                     ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cpu") -> DeviceMesh:
    """A ``DeviceMesh`` of ranks ``0..prod(shape)-1`` in row-major order
    over the initialised process group, which must have that many ranks."""
    n = math.prod(shape)
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(f"a {tuple(shape)} mesh needs a process group of "
                           f"{n} ranks (see fake_world)")
    return DeviceMesh(device_type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu") -> DeviceMesh:
    shape, axes = production_shape(multi_pod)
    return make_mesh(shape, axes, device_type)


@contextlib.contextmanager
def fake_world(n: int) -> Iterator[None]:
    """Rank 0 of an ``n``-rank process group on the fake backend for the
    body of the ``with``; the group is destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_axes(mesh: DeviceMesh) -> Tuple[Tuple[str, ...], Optional[str]]:
    """(data_axes, model_axis) for a mesh built by make_production_mesh."""
    names = mesh.mesh_dim_names
    model = "model" if "model" in names else None
    data = tuple(a for a in names if a in ("pod", "data"))
    return data, model


def chips(mesh: DeviceMesh) -> int:
    return mesh.size()
