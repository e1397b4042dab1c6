"""Transformer building blocks of the dense decoder-only models.

The dense subset of the JAX package's ``repro/models/layers.py``, as
functions over plain dicts of tensors: RMSNorm, rotary embeddings, GQA
attention (optional qk-norm, cross-attention through ``kv_source``) and the
SwiGLU MLP.  The JAX package's sharding hints are not carried over (they
are no-ops outside a mesh, and the port runs on one card); MLA, MoE and
M-RoPE come with their slice (ROADMAP.md Queue 1).

Attention over a whole sequence (``_sdpa``) goes through the hand-written
flash-attention kernel (:func:`repro_torch.kernels.ops.flash_attention`,
the JAX package's K6), which the JAX package's docstring names as the
replacement of its chunked einsum path on real hardware.  In fp32 the two
agree to rounding.  In bf16 the kernel rounds the probabilities to bf16 for
the product with v, as the JAX einsum path casts them to the working type,
but normalises by the sum of the rounded weights where that path
normalises first: the two agree within the bf16 tolerance of
``kernels/ref.py``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import ArchConfig

Params = Dict[str, Any]


# -- init ---------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype, scale: Optional[float] = None
               ) -> torch.Tensor:
    """A ``[d_in, d_out]`` weight: standard normal draws from ``gen`` (on
    its device) times ``scale`` (default 1/sqrt(d_in)), cast to ``dtype``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * scale).to(dtype)


def rmsnorm_init(d: int, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


# -- norms --------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    h = x.float()
    var = (h * h).mean(dim=-1, keepdim=True)
    return (h * torch.rsqrt(var + eps)).to(x.dtype) * g


# -- rotary embeddings --------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device: torch.device | str = "cpu") -> torch.Tensor:
    """The rotary frequencies in float64 (as the JAX package's numpy
    computes them), made on ``device``: a copy from the host would wait
    for the device at every layer."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float64,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x [..., S, H, dh]; positions [..., S] (int)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device).float()
    ang = positions[..., None].float() * freqs               # [..., S, dh/2]
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- attention ----------------------------------------------------------------

def gqa_init(gen: torch.Generator, cfg: ArchConfig,
             dtype: torch.dtype) -> Params:
    d, dh = cfg.d_model, cfg.head_dim
    p = {
        "wq": dense_init(gen, d, cfg.n_heads * dh, dtype),
        "wk": dense_init(gen, d, cfg.n_kv_heads * dh, dtype),
        "wv": dense_init(gen, d, cfg.n_kv_heads * dh, dtype),
        "wo": dense_init(gen, cfg.n_heads * dh, d, dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(dh, dtype, gen.device)
        p["k_norm"] = rmsnorm_init(dh, dtype, gen.device)
    return p


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, Hkv, dh] -> [B, S, Hkv * n_rep, dh]: head h reads KV head
    h // n_rep (``jnp.repeat`` on axis 2)."""
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=2)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          causal: bool) -> torch.Tensor:
    """q [B,Sq,H,dh], k/v [B,Sk,H,dh] -> [B,Sq,H,dh] through the
    flash-attention kernel; the causal mask is aligned top-left.

    The kernel never forms the [Sq, Sk] scores, so the JAX package's
    q-row chunking (``SDPA_CHUNK``, ``_sdpa_block``), which bounded that
    matrix, has no counterpart here."""
    b, sq, h, dh = q.shape
    sk = k.shape[1]

    def heads(t: torch.Tensor, s: int) -> torch.Tensor:
        return t.transpose(1, 2).reshape(b * h, s, dh)

    out = ops.flash_attention(heads(q, sq), heads(k, sk), heads(v, sk),
                              causal=causal)
    return out.reshape(b, h, sq, dh).transpose(1, 2)


def gqa_attention(p: Params, cfg: ArchConfig, x: torch.Tensor,
                  positions: torch.Tensor, cache: Optional[Dict] = None,
                  causal: bool = True,
                  kv_source: Optional[torch.Tensor] = None):
    """GQA self-attention (or cross-attention when ``kv_source`` is given).

    ``cache``: {"k","v" [B,Smax,Hkv,dh], "index" int} — the new keys and
    values are written into the cache tensors in place (where JAX returns
    updated copies) at ``index``; the returned cache holds the same tensors
    and ``index + S``.  A prompt written at index 0 attends over its own
    keys through the kernel, which equals the JAX package's softmax over
    all cache slots (the empty ones weigh exactly 0); any other step
    (decode) takes the masked product over the cache, as in JAX.
    """
    b, s, _ = x.shape
    dh = cfg.head_dim
    q = (x @ p["wq"]).reshape(b, s, cfg.n_heads, dh)
    src = kv_source if kv_source is not None else x
    sk = src.shape[1]
    k = (src @ p["wk"]).reshape(b, sk, cfg.n_kv_heads, dh)
    v = (src @ p["wv"]).reshape(b, sk, cfg.n_kv_heads, dh)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if kv_source is None:             # self-attention: rotary on q and k
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    n_rep = cfg.n_heads // cfg.n_kv_heads
    if cache is not None:
        idx = cache["index"]
        ck, cv = cache["k"], cache["v"]
        ck[:, idx:idx + s] = k
        cv[:, idx:idx + s] = v
        new_cache = {"k": ck, "v": cv, "index": idx + s}
        if idx == 0 and s > 1:
            out = _sdpa(q, _repeat_kv(k, n_rep), _repeat_kv(v, n_rep),
                        causal=True)
        else:
            # the group dim folded into q, the cache read once; products of
            # the working type summed in fp32 (JAX: preferred_element_type)
            qg = q.reshape(b, s, cfg.n_kv_heads, n_rep, dh)
            smax = ck.shape[1]
            kpos = torch.arange(smax, device=x.device)[None, :]
            qpos = idx + torch.arange(s, device=x.device)[:, None]
            mask = kpos <= qpos          # causal over the filled prefix
            logits = torch.einsum("bqhrd,bkhd->bhrqk", qg.float(),
                                  ck.float()) / math.sqrt(dh)
            logits = torch.where(mask, logits, -1e30)
            probs = torch.softmax(logits, dim=-1)
            out = torch.einsum("bhrqk,bkhd->bqhrd",
                               probs.to(x.dtype).float(), cv.float())
            out = out.reshape(b, s, cfg.n_heads, dh).to(x.dtype)
    else:
        kk = _repeat_kv(k, n_rep)
        vv = _repeat_kv(v, n_rep)
        out = _sdpa(q, kk, vv, causal=causal and kv_source is None)
        new_cache = None
    out = out.reshape(b, s, cfg.n_heads * dh)
    return out @ p["wo"], new_cache


# -- MLP ----------------------------------------------------------------------

def mlp_init(gen: torch.Generator, d: int, d_ff: int,
             dtype: torch.dtype) -> Params:
    return {"w1": dense_init(gen, d, d_ff, dtype),
            "w3": dense_init(gen, d, d_ff, dtype),
            "w2": dense_init(gen, d_ff, d, dtype)}


def mlp_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ p["w1"]) * (x @ p["w3"])
    return h @ p["w2"]
