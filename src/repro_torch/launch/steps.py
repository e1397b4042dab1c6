"""Step functions of the serving path: prefill and one decode step.

The counterparts of ``build_prefill_step`` and ``build_serve_step`` of the
JAX package's ``repro/launch/steps.py``.  PyTorch runs eagerly, so a step
is the plain function (no ``jit``); the train step comes with the
training slice.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig


def build_prefill_step(cfg: ArchConfig) -> Callable:
    def prefill_step(params, caches, batch):
        return M.prefill(cfg, params, batch["tokens"], caches)
    return prefill_step


def build_serve_step(cfg: ArchConfig) -> Callable:
    """One decode step: new token against a filled cache at ``index``."""
    def serve_step(params, caches, token, index):
        return M.decode_step(cfg, params, token, index, caches)
    return serve_step
