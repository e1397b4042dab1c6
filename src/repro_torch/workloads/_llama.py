"""Reduced-dimension LLaMA2-architecture model used by the LLM workloads.

The paper evaluates INT8 LLaMA2-7B inference and training (llama2.c [308]);
full-scale traces would be billions of page-ops, so — like the paper's own
12,000-instruction execution windows (Fig. 10) — the workloads trace a
dimension-reduced model with the identical architecture (RMSNorm, RoPE,
multi-head attention with causal mask, SwiGLU MLP, weight-tied logits).
The vectorizer quantizes every tensor to INT8 lanes (§5.4).

The parameters are a plain dict of tensors, an input of the traced
function as in the JAX package.  Its keys are inserted in sorted order:
``jax.tree_util`` flattens a dict by sorted key, ``torch.utils._pytree``
by insertion order, and the tracer numbers the input pages in flattening
order, so both packages must flatten the parameters alike.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch


def _sorted(**entries) -> Dict:
    return {k: entries[k] for k in sorted(entries)}


def init_params(rng: np.random.Generator, d: int, n_layers: int, n_heads: int,
                d_ff: int, vocab: int,
                device: torch.device | str = "cuda") -> Dict:
    """The JAX package's weights: the same draws from ``rng``, in its order
    (per layer wq, wk, wv, wo, w1, w2, w3; then emb)."""
    def w(*shape):
        return torch.from_numpy(
            rng.normal(0, 0.02, size=shape).astype(np.float32)).to(device)

    def ones():
        return torch.ones((d,), dtype=torch.float32, device=device)

    layers = []
    for _ in range(n_layers):
        wq, wk, wv, wo = w(d, d), w(d, d), w(d, d), w(d, d)
        w1, w2, w3 = w(d, d_ff), w(d_ff, d), w(d, d_ff)
        layers.append(_sorted(wq=wq, wk=wk, wv=wv, wo=wo, w1=w1, w2=w2,
                              w3=w3, ln1=ones(), ln2=ones()))
    return _sorted(emb=w(vocab, d), lnf=ones(), layers=layers)


def params_from_numpy(tree: Dict, device: torch.device | str = "cuda"
                      ) -> Dict:
    """The port's parameters from a parameter tree of numpy arrays (such
    as the JAX package's, after ``np.asarray`` on every leaf)."""
    def leaf(x):
        return torch.from_numpy(np.array(x, copy=True)).to(device)

    return _sorted(
        emb=leaf(tree["emb"]), lnf=leaf(tree["lnf"]),
        layers=[_sorted(**{k: leaf(v) for k, v in layer.items()})
                for layer in tree["layers"]])


def rmsnorm(x, g):
    var = (x * x).mean(-1, keepdim=True)
    return x * torch.rsqrt(var + 1e-5) * g


def rope(x, cos, sin):
    h = x.shape[-1] // 2
    x1, x2 = x[..., :h], x[..., h:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(x, layer, n_heads, cos, sin, mask):
    seq, d = x.shape
    dh = d // n_heads
    q = (x @ layer["wq"]).reshape(seq, n_heads, dh).permute(1, 0, 2)
    k = (x @ layer["wk"]).reshape(seq, n_heads, dh).permute(1, 0, 2)
    v = (x @ layer["wv"]).reshape(seq, n_heads, dh).permute(1, 0, 2)
    q = rope(q, cos, sin)
    k = rope(k, cos, sin)
    scores = torch.einsum("hqd,hkd->hqk", q, k) / math.sqrt(dh)
    scores = torch.where(mask, scores, -1e9)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("hqk,hkd->hqd", probs, v)
    out = out.permute(1, 0, 2).reshape(seq, d)
    return out @ layer["wo"]


def mlp(x, layer):
    return (torch.nn.functional.silu(x @ layer["w1"])
            * (x @ layer["w3"])) @ layer["w2"]


def forward(params, tokens, cos, sin, mask, n_heads: int):
    x = params["emb"][tokens]
    for layer in params["layers"]:
        x = x + attention(rmsnorm(x, layer["ln1"]), layer, n_heads, cos, sin,
                          mask)
        x = x + mlp(rmsnorm(x, layer["ln2"]), layer)
    x = rmsnorm(x, params["lnf"])
    return x @ params["emb"].T          # weight-tied logits


def make_rope_tables(rng, seq: int, dh: int,
                     device: torch.device | str = "cuda"):
    t = np.arange(seq)[:, None]
    freqs = 1.0 / (10000 ** (np.arange(dh // 2)[None, :] / (dh // 2)))
    ang = t * freqs
    return (torch.from_numpy(np.cos(ang).astype(np.float32)).to(device),
            torch.from_numpy(np.sin(ang).astype(np.float32)).to(device))


def causal_mask(seq: int, device: torch.device | str = "cuda"):
    return torch.from_numpy(np.tril(np.ones((1, seq, seq), bool))).to(device)
