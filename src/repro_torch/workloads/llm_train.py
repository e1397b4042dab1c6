"""LLM training workload (§5.4 workload 6).

One causal-LM training step (forward, cross-entropy loss, full backward via
``torch.func.grad_and_value``, SGD update) on the reduced-dimension LLaMA2
architecture (see :mod:`repro_torch.workloads._llama`).  The backward pass
and the weight update contribute large volumes of medium-latency adds/muls
and write traffic to every weight page — Table 3: 60% vectorizable, reuse
5.2, 88% medium / 12% high; bandwidth-intensive.

The tracer records the gradient as the JAX package's ``jax.value_and_grad``
does (:mod:`repro_torch.core.autodiff`): the numbers are torch autograd's,
the emitted instruction stream is the linearised and transposed program.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.workloads import _llama

SCALES = {
    "tiny": dict(d=128, n_layers=1, n_heads=2, d_ff=256, vocab=512, seq=8),
    "paper": dict(d=768, n_layers=3, n_heads=8, d_ff=2048, vocab=8192,
                  seq=48),
}


def make_fn(scale: str = "paper"):
    p = SCALES[scale]

    def loss_fn(params, tokens, labels, cos, sin, mask):
        logits = _llama.forward(params, tokens, cos, sin, mask, p["n_heads"])
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, labels[:, None], dim=-1)[:, 0]
        return (logz - gold).mean()

    def train_step(params, tokens, labels, cos, sin, mask):
        grads, loss = torch.func.grad_and_value(loss_fn)(
            params, tokens, labels, cos, sin, mask)
        new_params = torch.utils._pytree.tree_map(
            lambda w, g: w - 0.01 * g, params, grads)
        return loss, new_params

    return train_step


def make_inputs(scale: str = "paper", seed: int = 0,
                device: torch.device | str = "cuda"):
    p = SCALES[scale]
    rng = np.random.default_rng(seed)
    params = _llama.init_params(rng, p["d"], p["n_layers"], p["n_heads"],
                                p["d_ff"], p["vocab"], device=device)
    tokens = torch.from_numpy(rng.integers(0, p["vocab"], size=(p["seq"],),
                                           dtype=np.int32)).to(device)
    # drawn as the reference draws them; held as int64, the index type of
    # ``take_along_dim`` (a conversion inside the program would be an
    # instruction that the reference's trace does not have)
    labels = torch.from_numpy(rng.integers(0, p["vocab"], size=(p["seq"],),
                                           dtype=np.int32)).to(device,
                                                               torch.int64)
    cos, sin = _llama.make_rope_tables(rng, p["seq"], p["d"] // p["n_heads"],
                                       device=device)
    mask = _llama.causal_mask(p["seq"], device=device)
    return (params, tokens, labels, cos, sin, mask)


SIM = dict(dram_frac=0.35, host_frac=0.3)
META = dict(paper_vect=60, paper_reuse=5.2, paper_low=0, paper_med=88,
            paper_high=12, kind="compute_intensive")

VECTORIZE_KW = dict(matmul_k_steps=16)
