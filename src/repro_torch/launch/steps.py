"""Step functions: the train step, prefill and one decode step.

The counterparts of ``extra_inputs``, ``build_train_step``,
``build_prefill_step`` and ``build_serve_step`` of the JAX package's
``repro/launch/steps.py``.  PyTorch runs eagerly, so a step is the plain
function (no ``jit``).  The train step is a full optimization step: loss,
backward (autograd of ``lm_loss``), AdamW with the arch's schedule.  A
batch may carry the modality stubs ``extra_inputs`` describes
(``extra_embeds`` and ``pos3`` for a VLM, ``enc_feats`` for an audio
encoder-decoder) beside ``tokens`` and ``labels``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig
from repro_torch.optim import adamw_update, make_schedule

# the batch entries lm_loss and prefill take besides the tokens
EXTRAS = ("extra_embeds", "pos3", "enc_feats")
# entries the JAX package's microbatch loop passes whole
# (repro/launch/steps.py:63-68), which fails there (R8, ROADMAP.md)
UNSLICED = ("pos3", "enc_feats")


def extra_inputs(cfg: ArchConfig, batch: int, seq: int
                 ) -> Dict[str, torch.Tensor]:
    """Modality-frontend STUBS: the shapes and dtypes of the precomputed
    frame or patch embeddings and the auxiliary position streams, as
    tensors on the ``meta`` device (``jax.ShapeDtypeStruct`` in the JAX
    package)."""
    extras: Dict[str, torch.Tensor] = {}
    if cfg.frontend == "vision_patches":
        n_patch = 64                       # one low-res image per sequence
        extras["extra_embeds"] = torch.empty(
            (batch, n_patch, cfg.d_model), dtype=torch.bfloat16,
            device="meta")
        extras["pos3"] = torch.empty((3, batch, seq + n_patch),
                                     dtype=torch.int32, device="meta")
    elif cfg.frontend == "audio_frames":
        n_frames = max(8, seq // 4)        # encoder frames per utterance
        extras["enc_feats"] = torch.empty(
            (batch, n_frames, cfg.d_model), dtype=torch.bfloat16,
            device="meta")
    return extras


def loss_and_grads(cfg: ArchConfig, params: M.Params,
                   batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, M.Params]:
    """``lm_loss`` on ``batch`` (with its stubs) and its gradient with
    respect to every parameter (``jax.value_and_grad``): (loss, grads in
    the parameters' tree and dtypes).  A parameter the loss never reaches
    (the reduced zamba2's shared block, seamless's encoder without
    ``enc_feats``) gets zeros, as under ``jax.grad``."""
    leaves, spec = pytree.tree_flatten(params)
    leaves = [p.detach().requires_grad_() for p in leaves]
    loss = M.lm_loss(cfg, pytree.tree_unflatten(leaves, spec),
                     batch["tokens"], batch["labels"],
                     **{k: batch[k] for k in EXTRAS if k in batch})
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), pytree.tree_unflatten(list(grads), spec)


def build_train_step(cfg: ArchConfig, total_steps: int = 10_000,
                     base_lr: float = 3e-4,
                     microbatches: int = 1) -> Callable:
    """Full optimization step ``(params, opt_state, batch) -> (params,
    opt_state, {"loss", "lr", "grad_norm"})``.  ``microbatches > 1``
    accumulates fp32 gradients over batch slices in a loop (the JAX
    package's ``lax.scan``) and divides the sums at the end: a smaller
    activation peak.  With ``pos3`` or ``enc_feats`` in the batch it
    raises ``ValueError`` before any work: the JAX package passes those
    whole to every microbatch and fails (``pos3`` is not batch-major, so
    slicing it on axis 0 would be wrong too)."""
    schedule = make_schedule(cfg.schedule, base_lr, total_steps)

    def train_step(params, opt_state, batch):
        step = opt_state.step
        if microbatches == 1:
            loss, grads = loss_and_grads(cfg, params, batch)
        else:
            unsliced = [k for k in UNSLICED if k in batch]
            if unsliced:
                raise ValueError(f"microbatches={microbatches} with "
                                 f"{unsliced} in the batch: the JAX "
                                 f"package passes them whole to each "
                                 f"microbatch and fails")
            b = batch["tokens"].shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} does not split into "
                                 f"{microbatches} microbatches")
            mb = b // microbatches
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            grads = pytree.tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
            for i in range(microbatches):
                l, g = loss_and_grads(
                    cfg, params, {k: v[i * mb:(i + 1) * mb]
                                  for k, v in batch.items()})
                grads = pytree.tree_map(lambda a, b_: a + b_.float(),
                                        grads, g)
                loss = loss + l
            loss = loss / microbatches
            grads = pytree.tree_map(lambda g: g / microbatches, grads)
        lr = schedule(step)
        new_params, new_state, metrics = adamw_update(
            params, grads, opt_state, lr)
        metrics = dict(metrics, loss=loss, lr=lr)
        return new_params, new_state, metrics

    return train_step


def build_prefill_step(cfg: ArchConfig, flash: bool = True) -> Callable:
    """Prefill of ``batch["tokens"]`` with the batch's stubs, if any;
    ``flash=False`` attends through the einsum path instead of the
    kernel."""
    def prefill_step(params, caches, batch):
        return M.prefill(cfg, params, batch["tokens"], caches,
                         **{k: batch[k] for k in EXTRAS if k in batch},
                         flash=flash)
    return prefill_step


def build_serve_step(cfg: ArchConfig) -> Callable:
    """One decode step: new token against a filled cache at ``index``,
    cross-attending to ``enc_out`` when given."""
    def serve_step(params, caches, token, index,
                   enc_out: Optional[torch.Tensor] = None):
        return M.decode_step(cfg, params, token, index, caches,
                             enc_out=enc_out)
    return serve_step
