"""LLaMA2 INT8 inference workload (§5.4 workload 5).

Prefill over a prompt plus greedy decode steps on the reduced-dimension
LLaMA2 architecture (see :mod:`repro_torch.workloads._llama`).  Matmuls
dominate (mul+add pairs after decomposition), softmax contributes exp
(high-latency), RMSNorm/residuals contribute medium-latency adds, embedding
lookups are gathers (ISP-class) — Table 3: 70% vectorizable, reuse 1.8,
53% medium / 47% high.

The emitted tokens stay int64, as ``torch.argmax`` gives them: ``jnp.argmax``
gives int32, but a conversion inside the program would be an instruction
the JAX package's trace does not have, and under INT8 quantization the
element width does not change the page math.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.workloads import _llama

SCALES = {
    "tiny": dict(d=128, n_layers=1, n_heads=2, d_ff=256, vocab=512,
                 seq=8, decode_steps=1),
    "paper": dict(d=1024, n_layers=3, n_heads=8, d_ff=2816, vocab=8192,
                  seq=48, decode_steps=2),
}


def make_fn(scale: str = "paper"):
    p = SCALES[scale]

    def infer(params, tokens, cos, sin, mask):
        # prefill
        logits = _llama.forward(params, tokens, cos, sin, mask, p["n_heads"])
        nxt = torch.argmax(logits[-1])
        outs = [nxt]
        # greedy decode (full-context recompute per emitted token)
        for _ in range(p["decode_steps"]):
            tokens = torch.cat([tokens[1:], nxt[None]])
            logits = _llama.forward(params, tokens, cos, sin, mask,
                                    p["n_heads"])
            nxt = torch.argmax(logits[-1])
            outs.append(nxt)
        return torch.stack(outs)

    return infer


def make_inputs(scale: str = "paper", seed: int = 0,
                device: torch.device | str = "cuda"):
    p = SCALES[scale]
    rng = np.random.default_rng(seed)
    params = _llama.init_params(rng, p["d"], p["n_layers"], p["n_heads"],
                                p["d_ff"], p["vocab"], device=device)
    tokens = torch.from_numpy(rng.integers(0, p["vocab"], size=(p["seq"],),
                                           dtype=np.int32)).to(device)
    cos, sin = _llama.make_rope_tables(rng, p["seq"], p["d"] // p["n_heads"],
                                       device=device)
    mask = _llama.causal_mask(p["seq"], device=device)
    return (params, tokens, cos, sin, mask)


SIM = dict(dram_frac=0.35, host_frac=0.3)
META = dict(paper_vect=70, paper_reuse=1.8, paper_low=0, paper_med=53,
            paper_high=47, kind="compute_intensive")

VECTORIZE_KW = dict(matmul_k_steps=16)
