"""Training driver.

End-to-end training of any ``--arch`` (reduced config by default)
with checkpoint/restart, deterministic data, straggler monitoring, and
optional fault injection; on the GPU the same driver runs the full config.
The counterpart of the JAX package's ``repro/launch/train.py``: it prints
the same ``[train]`` lines, with each step's wall time taken after the
step's loss has reached the host.  Its batches are the synthetic stream's
tokens and labels only, as in the JAX package: a VLM trains without patch
stubs and an encoder-decoder without frames (its encoder and
cross-attention then get zero gradients).

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --steps 100 --batch 8 --seq 64 --ckpt-dir ckpt [--device cpu]
  # crash at step 37 and restart from the last checkpoint:
  ... --fail-at 37 --max-restarts 1

It runs on the GPU unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.elastic import (SimulatedFailure, StragglerMonitor,
                                        run_elastic)
from repro_torch.launch.steps import build_train_step
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig
from repro_torch.optim.adamw import AdamWState, adamw_init


def device_batch(batch: dict, device: torch.device | str) -> dict:
    """A numpy batch (``SyntheticLM``'s int32 tokens and labels) as int64
    tensors on ``device``, the index type of ``torch.take_along_dim``."""
    return {k: torch.from_numpy(v).to(device=device, dtype=torch.int64)
            for k, v in batch.items()}


def make_state(cfg: ArchConfig, seed: int,
               device: torch.device | str) -> dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = M.init_params(cfg, gen)
    return {"params": params, "opt": adamw_init(params)}


def state_from_numpy(cfg: ArchConfig, params_tree: dict, opt_tree,
                     device: torch.device | str,
                     dtype: Optional[torch.dtype] = None) -> dict:
    """The port's training state from the JAX package's
    ``{"params": ..., "opt": AdamWState(step, mu, nu)}`` with numpy leaves
    (``opt_tree`` is anything with ``step``, ``mu`` and ``nu``): the
    parameters in ``dtype`` (default ``cfg.dtype``) and the moments in
    fp32 through :func:`repro_torch.models.model.params_from_numpy`, on
    ``device``."""
    return {"params": M.params_from_numpy(cfg, params_tree, device, dtype),
            "opt": AdamWState(
                step=torch.tensor(int(opt_tree.step), dtype=torch.int32,
                                  device=device),
                mu=M.params_from_numpy(cfg, opt_tree.mu, device,
                                       torch.float32),
                nu=M.params_from_numpy(cfg, opt_tree.nu, device,
                                       torch.float32))}


def train(arch: str, steps: int, batch: int, seq: int,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 20,
          reduced: bool = True, fail_at: Optional[int] = None,
          seed: int = 0, log_every: int = 10,
          resume: bool = True, base_lr: float = 1e-3,
          device: Optional[torch.device | str] = None) -> dict:
    """Train ``arch`` for ``steps`` steps on the synthetic stream;
    ``device=None`` means the GPU."""
    device = resolve_device(device)
    cfg = configs.get(arch)
    if reduced:
        cfg = cfg.reduced()
    data = SyntheticLM(cfg.vocab, seq, batch, seed=seed)
    step_fn = build_train_step(cfg, total_steps=steps, base_lr=base_lr)
    state = make_state(cfg, seed, device)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start = 0
    if mgr is not None and resume and mgr.latest_step() is not None:
        state, manifest = mgr.restore(state)
        start = manifest["step"]
        print(f"[train] resumed from checkpoint step {start}")

    mon = StragglerMonitor()
    losses = []
    for step in range(start, steps):
        if fail_at is not None and step == fail_at:
            raise SimulatedFailure(f"injected node failure at step {step}")
        t0 = time.time()
        params, opt, metrics = step_fn(state["params"], state["opt"],
                                       device_batch(data.batch(step), device))
        state = {"params": params, "opt": opt}
        loss = float(metrics["loss"])          # waits for the device
        dt = time.time() - t0
        straggler = mon.observe(dt)
        losses.append(loss)
        if step % log_every == 0 or step == steps - 1:
            print(f"[train] step {step:5d} loss {loss:8.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):7.3f} "
                  f"{dt*1e3:7.1f}ms{'  STRAGGLER' if straggler else ''}")
        if mgr is not None and (step + 1) % ckpt_every == 0:
            mgr.save(step + 1, state, extra={"arch": arch, "loss": loss})
    if mgr is not None:
        mgr.save(steps, state, extra={"arch": arch}, blocking=True)
        mgr.wait()
    return {"final_loss": losses[-1] if losses else None,
            "first_loss": losses[0] if losses else None,
            "stragglers": mon.flagged, "state": state,
            "losses": losses}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    choices=configs.ARCHS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--full", action="store_true",
                    help="use the full (non-reduced) config")
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU")
    args = ap.parse_args()

    attempted = {"n": 0}

    def once(_resume_step):
        # fail only on the first attempt so the restart proves recovery
        fail = args.fail_at if attempted["n"] == 0 else None
        attempted["n"] += 1
        res = train(args.arch, args.steps, args.batch, args.seq,
                    ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                    reduced=not args.full, fail_at=fail, base_lr=args.lr,
                    device=args.device)
        print(f"[train] done: first_loss={res['first_loss']:.4f} "
              f"final_loss={res['final_loss']:.4f} "
              f"stragglers={res['stragglers']}")
        return args.steps

    run_elastic(once, max_restarts=args.max_restarts,
                on_restart=lambda n, e: print(f"[elastic] restart #{n}: {e}"))


if __name__ == "__main__":
    main()
