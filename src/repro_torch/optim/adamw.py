"""AdamW with fp32 moments over (possibly bf16) params, global-norm clip.

The counterpart of the JAX package's ``repro/optim/adamw.py``, as plain
functions on the port's parameter trees (dicts and lists of tensors): the
moments mirror the parameters' structure in float32, and
:func:`adamw_update` is functional, as the reference is: it returns new
tensors and leaves its inputs untouched.  Every operation runs in the
order and precision of the reference's (float32 throughout, the result
cast back to the parameter's type).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils import _pytree as pytree


class AdamWState(NamedTuple):
    step: torch.Tensor          # 0-d int32, on the parameters' device
    mu: Any
    nu: Any


def aligned_leaves(like, tree) -> list:
    """The leaves of ``tree`` in the order of ``like``'s, which has the
    same structure: dicts are matched by key, whatever their order."""
    return pytree.tree_leaves(pytree.tree_map(lambda _, x: x, like, tree))


def adamw_init(params) -> AdamWState:
    leaves = pytree.tree_leaves(params)
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=leaves[0].device),
        mu=pytree.tree_map(zeros, params),
        nu=pytree.tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in pytree.tree_leaves(tree)))


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0):
    """One AdamW step; returns (new_params, new_state, metrics)."""
    gnorm = global_norm(grads)
    # a tensor numerator: ``float / Tensor`` would multiply by the
    # reciprocal, which rounds twice
    scale = torch.clamp(torch.full_like(gnorm, clip_norm) / (gnorm + 1e-9),
                        max=1.0)
    step = state.step + 1
    t = step.to(torch.float32)
    bc1 = 1 - b1 ** t
    bc2 = 1 - b2 ** t

    def upd(p, g, m, v):
        g = g.float() * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    flat_p, spec = pytree.tree_flatten(params)
    out = [upd(p, g, m, v) for p, g, m, v in zip(
        flat_p, aligned_leaves(params, grads),
        aligned_leaves(params, state.mu), aligned_leaves(params, state.nu))]
    new_p, new_m, new_v = (pytree.tree_unflatten([o[i] for o in out], spec)
                           for i in range(3))
    return new_p, AdamWState(step, new_m, new_v), {"grad_norm": gnorm}
