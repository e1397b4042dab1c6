"""Step functions: the train step, prefill and one decode step.

The counterparts of ``build_train_step``, ``build_prefill_step`` and
``build_serve_step`` of the JAX package's ``repro/launch/steps.py``.
PyTorch runs eagerly, so a step is the plain function (no ``jit``).  The
train step is a full optimization step: loss, backward (autograd of
``lm_loss``), AdamW with the arch's schedule.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig
from repro_torch.optim import adamw_update, make_schedule


def loss_and_grads(cfg: ArchConfig, params: M.Params,
                   batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, M.Params]:
    """``lm_loss`` on ``batch`` and its gradient with respect to every
    parameter (``jax.value_and_grad``): (loss, grads in the parameters'
    tree and dtypes)."""
    leaves, spec = pytree.tree_flatten(params)
    leaves = [p.detach().requires_grad_() for p in leaves]
    loss = M.lm_loss(cfg, pytree.tree_unflatten(leaves, spec),
                     batch["tokens"], batch["labels"])
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), pytree.tree_unflatten(list(grads), spec)


def build_train_step(cfg: ArchConfig, total_steps: int = 10_000,
                     base_lr: float = 3e-4,
                     microbatches: int = 1) -> Callable:
    """Full optimization step ``(params, opt_state, batch) -> (params,
    opt_state, {"loss", "lr", "grad_norm"})``.  ``microbatches > 1``
    accumulates fp32 gradients over batch slices in a loop (the JAX
    package's ``lax.scan``) and divides the sums at the end: a smaller
    activation peak."""
    schedule = make_schedule(cfg.schedule, base_lr, total_steps)

    def train_step(params, opt_state, batch):
        step = opt_state.step
        if microbatches == 1:
            loss, grads = loss_and_grads(cfg, params, batch)
        else:
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


def build_prefill_step(cfg: ArchConfig) -> Callable:
    def prefill_step(params, caches, batch):
        return M.prefill(cfg, params, batch["tokens"], caches)
    return prefill_step


def build_serve_step(cfg: ArchConfig) -> Callable:
    """One decode step: new token against a filled cache at ``index``."""
    def serve_step(params, caches, token, index):
        return M.decode_step(cfg, params, token, index, caches)
    return serve_step
