"""input_specs: DTensor stand-ins for every (arch x shape) cell.

The counterpart of the JAX package's ``repro/launch/specs.py``.  Every
argument of a cell's step (params, AdamW state, caches, tokens, modality
stubs) is a DTensor of its global shape, laid out on the mesh by the
sharding plan (:mod:`repro_torch.launch.sharding`), whose local shard is
a fake tensor (``FakeTensorMode``): nothing is allocated, so
deepseek-v2-236b's 472 GB of parameters plan on any host.  The programs
attend through the einsum path (``flash=False``), the path the JAX
package's models lower; the flash-attention kernel is not a DTensor op.

A step runs on these arguments under ``implicit_replication`` (a plain
tensor made inside the program, such as a mask or a position index, is
taken as replicated, as a constant is under ``jit``), on a process group
of the mesh's size: the fake one of :func:`repro_torch.launch.mesh
.fake_world` for a production mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import DeviceMesh
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs
from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable
from repro_torch.launch import sharding as SH
from repro_torch.launch.steps import (build_prefill_step, build_serve_step,
                                      build_train_step, extra_inputs)
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig
from repro_torch.optim.adamw import adamw_init

META = torch.device("meta")


class _MetaInit(TorchDispatchMode):
    """Every factory on the meta device and every random draw an empty
    tensor: an init's shapes and dtypes without its values or memory."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if func is torch.ops.aten.randn.generator:
            return torch.empty(args[0], dtype=kwargs.get("dtype"),
                               device=META)
        if "device" in kwargs:
            kwargs["device"] = META
        return func(*args, **kwargs)


def params_shapes(cfg: ArchConfig) -> M.Params:
    """The parameter tree of ``init_params(cfg, ...)`` as meta tensors.
    One block of each kind is initialised and shared by every layer of
    that kind (the layers of a kind have equal shapes), so that
    deepseek-v2-236b's 28800 expert draws need not run."""
    kinds = tuple(dict.fromkeys(cfg.pattern))
    one = dataclasses.replace(cfg, n_layers=len(kinds), block_pattern=kinds)
    with _MetaInit():
        p = M.init_params(one, torch.Generator())
    blocks = dict(zip(kinds, p["layers"]))
    p["layers"] = [blocks[kind] for kind in cfg.pattern]
    return p


def cache_shapes(cfg: ArchConfig, batch: int, max_seq: int):
    return M.init_cache(cfg, batch, max_seq, META)


def _meta(shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(arch: str, shape: str, mesh: DeviceMesh,
                cfg: Optional[ArchConfig] = None,
                spec: Optional[ShapeSpec] = None
                ) -> Tuple[Callable, Tuple, str]:
    """Returns (step_fn, example_args, kind) for one cell; the args are
    DTensors with fake local shards.

    kind in {train, prefill, decode}.  Raises ValueError for inapplicable
    cells (long_500k on pure full-attention archs) with the skip reason.
    A decode step's position is the host int ``seq_len - 1`` (the JAX
    package passes an int32 scalar argument).  ``cfg`` and ``spec``
    replace the arch's config and the shape's sizes (the tests plan
    reduced configs at small sizes)."""
    cfg = cfg or configs.get(arch)
    spec = spec or SHAPES[shape]
    ok, reason = applicable(cfg, shape)
    if not ok:
        raise ValueError(reason)
    b, s = spec.global_batch, spec.seq_len
    extras = extra_inputs(cfg, b, min(s, 4096) if spec.kind == "train"
                          else s)
    p_shapes = params_shapes(cfg)

    with FakeTensorMode(allow_non_fake_inputs=True):
        params = SH.to_dtensors(p_shapes, SH.param_specs(p_shapes, mesh),
                                mesh)

        def tokens(shape_):
            return SH.sharded_like(_meta(shape_),
                                   SH.batch_spec(shape_, mesh), mesh)

        def stubs() -> Dict[str, Any]:
            out = {}
            for k, v in extras.items():
                if k in ("extra_embeds", "enc_feats"):
                    sp = SH.embeds_spec(v.shape, mesh)
                else:
                    sp = (None,) * v.ndim
                out[k] = SH.sharded_like(v, sp, mesh)
            return out

        def caches(max_seq):
            c = cache_shapes(cfg, b, max_seq)
            return SH.to_dtensors(c, SH.cache_specs(c, mesh), mesh)

        if spec.kind == "train":
            o_shapes = adamw_init(p_shapes)
            opt = SH.to_dtensors(o_shapes, SH.param_specs(o_shapes, mesh),
                                 mesh)
            batch = {"tokens": tokens((b, s)), "labels": tokens((b, s))}
            batch.update(stubs())
            return build_train_step(cfg), (params, opt, batch), "train"

        if spec.kind == "prefill":
            n_extra = (extras["extra_embeds"].shape[1]
                       if "extra_embeds" in extras else 0)
            batch = {"tokens": tokens((b, s))}
            batch.update(stubs())
            return (build_prefill_step(cfg, flash=False),
                    (params, caches(s + n_extra), batch), "prefill")

        # decode: one new token against a seq_len-deep cache
        args = [params, caches(s), tokens((b,)), s - 1]
        if cfg.enc_layers:
            enc_shape = (b, max(8, min(s, 4096) // 4), cfg.d_model)
            args.append(SH.sharded_like(
                _meta(enc_shape, torch.bfloat16),
                SH.embeds_spec(enc_shape, mesh), mesh))
        return build_serve_step(cfg), tuple(args), "decode"
