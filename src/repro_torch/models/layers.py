"""Transformer building blocks shared by the architectures.

The counterpart of the JAX package's ``repro/models/layers.py``, as
functions over plain dicts of tensors: RMSNorm, rotary embeddings (and
Qwen2-VL's multimodal M-RoPE), GQA attention (optional qk-norm,
cross-attention through ``kv_source``), DeepSeek-V2's multi-head latent
attention (MLA), the SwiGLU MLP and the top-k token-choice MoE with its
capacity-bounded dispatch.  The JAX package's sharding hints are not
carried over (they are no-ops outside a mesh, and the port runs on one
card), nor is its expert-parallel ``shard_map`` MoE path, which needs a
mesh: the MoE here is the reference's single-device path.

Attention over a whole sequence (``_sdpa``) takes one of two paths, chosen
by the caller's ``flash`` argument.  Serving (``flash=True``) goes through
the hand-written flash-attention kernel
(:func:`repro_torch.kernels.ops.flash_attention`, the JAX package's K6),
which the JAX package's docstring names as the replacement of its chunked
einsum path on real hardware.  In fp32 the two agree to rounding.  In bf16
the kernel rounds the probabilities to bf16 for the product with v, as the
JAX einsum path casts them to the working type, but normalises by the sum
of the rounded weights where that path normalises first: the two agree
within the bf16 tolerance of ``kernels/ref.py``.  Training
(``flash=False``) takes the JAX package's own chunked einsum path
(``SDPA_CHUNK``, ``_sdpa_block``): K6 has no backward there either, and
refuses autograd here.  MLA never reaches ``_sdpa`` in the reference (its
q·k width, dh + ``rope_head_dim``, is not v's), so it keeps its masked
einsum product here too and launches no kernel.
"""
from __future__ import annotations

import dataclasses
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


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                theta: float = 10_000.0, sections=(2, 1, 1)) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: the rotary dim is split into (t, h, w)
    sections, each rotated by its own position stream.

    x [B, S, H, dh]; positions3 [3, B, S]."""
    dh = x.shape[-1]
    total = sum(sections)
    cuts = [dh * s // total for s in sections]
    cuts[-1] = dh - sum(cuts[:-1])
    outs = []
    off = 0
    for sec, width in enumerate(cuts):
        outs.append(apply_rope(x[..., off:off + width], positions3[sec],
                               theta))
        off += width
    return torch.cat(outs, dim=-1)


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


SDPA_CHUNK = 512   # q-block size for chunked attention (long sequences)


def _sdpa_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, q_offset: int) -> torch.Tensor:
    """The JAX package's ``_sdpa_block``: scores of the working type's
    operands summed in fp32 (bf16 products are exact in fp32, so operands
    cast to fp32 give ``preferred_element_type=float32``'s numbers), -1e30
    under the mask, an fp32 softmax, the probabilities cast to the working
    type for the product with v, summed in fp32."""
    dh = q.shape[-1]
    scale = 1.0 / math.sqrt(dh)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(sk, device=q.device)[None, :]
        logits = torch.where(qpos >= kpos, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          causal: bool, flash: bool) -> torch.Tensor:
    """q [B,Sq,H,dh], k/v [B,Sk,H,dh] -> [B,Sq,H,dh]; the causal mask is
    aligned top-left.

    ``flash``: through the flash-attention kernel, which never forms the
    [Sq, Sk] scores.  Otherwise the JAX package's einsum path: a sequence
    longer than ``SDPA_CHUNK`` and a multiple of it goes in q-row blocks
    (the reference's ``lax.scan``), so that only [B,H,C,Sk] scores exist
    at a time."""
    b, sq, h, dh = q.shape
    if not flash:
        if sq <= SDPA_CHUNK or sq % SDPA_CHUNK != 0:
            return _sdpa_block(q, k, v, causal, 0)
        return torch.cat([_sdpa_block(q[:, i:i + SDPA_CHUNK], k, v, causal,
                                      i)
                          for i in range(0, sq, SDPA_CHUNK)], dim=1)
    sk = k.shape[1]

    def heads(t: torch.Tensor, s: int) -> torch.Tensor:
        return t.transpose(1, 2).reshape(b * h, s, dh)

    out = ops.flash_attention(heads(q, sq), heads(k, sk), heads(v, sk),
                              causal=causal)
    return out.reshape(b, h, sq, dh).transpose(1, 2)


def gqa_attention(p: Params, cfg: ArchConfig, x: torch.Tensor,
                  positions: torch.Tensor, cache: Optional[Dict] = None,
                  pos3: Optional[torch.Tensor] = None,
                  causal: bool = True,
                  kv_source: Optional[torch.Tensor] = None,
                  flash: bool = True):
    """GQA self-attention (or cross-attention when ``kv_source`` is given).
    Self-attention rotates q and k by M-RoPE over ``pos3`` [3, B, S] when
    the config has ``mrope`` and ``pos3`` is given, else by RoPE over
    ``positions``.

    ``flash`` chooses the whole-sequence attention of ``_sdpa``: the
    flash-attention kernel (serving) or the einsum path (training, which
    needs a backward).

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
        if cfg.mrope and pos3 is not None:
            q = apply_mrope(q, pos3, cfg.rope_theta)
            k = apply_mrope(k, pos3, cfg.rope_theta)
        else:
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
                        causal=True, flash=flash)
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
        out = _sdpa(q, kk, vv, causal=causal and kv_source is None,
                    flash=flash)
        new_cache = None
    out = out.reshape(b, s, cfg.n_heads * dh)
    return out @ p["wo"], new_cache


# -- MLA (DeepSeek-V2 multi-head latent attention) ----------------------------

def mla_init(gen: torch.Generator, cfg: ArchConfig,
             dtype: torch.dtype) -> Params:
    d, dh, r = cfg.d_model, cfg.head_dim, cfg.kv_lora_rank
    rd = cfg.rope_head_dim
    p = {
        # compressed KV path: d -> r (+ decoupled rope key)
        "w_dkv": dense_init(gen, d, r + rd, dtype),
        "kv_norm": rmsnorm_init(r, dtype, gen.device),
        "w_uk": dense_init(gen, r, cfg.n_heads * dh, dtype),
        "w_uv": dense_init(gen, r, cfg.n_heads * dh, dtype),
        "wo": dense_init(gen, cfg.n_heads * dh, d, dtype),
    }
    if cfg.q_lora_rank:
        p["w_dq"] = dense_init(gen, d, cfg.q_lora_rank, dtype)
        p["q_norm"] = rmsnorm_init(cfg.q_lora_rank, dtype, gen.device)
        p["w_uq"] = dense_init(gen, cfg.q_lora_rank,
                               cfg.n_heads * (dh + rd), dtype)
    else:
        p["w_q"] = dense_init(gen, d, cfg.n_heads * (dh + rd), dtype)
    return p


def mla_attention(p: Params, cfg: ArchConfig, x: torch.Tensor,
                  positions: torch.Tensor, cache: Optional[Dict] = None):
    """Multi-head latent attention: KV compressed to ``kv_lora_rank`` (the
    cache stores only the r + ``rope_head_dim`` latent) and up-projected
    per head at attention time.

    ``cache``: {"latent" [B,Smax,r], "k_rope" [B,Smax,rd], "index" int},
    written in place at ``index``; attention then runs over every cache
    slot under the causal mask, as in the JAX package.  Without a cache, a
    sequence longer than ``SDPA_CHUNK`` and a multiple of it goes in q-row
    blocks (the reference's ``lax.scan``).  Scores are products of the
    working type summed in fp32 (``preferred_element_type``)."""
    b, s, _ = x.shape
    dh, r, rd = cfg.head_dim, cfg.kv_lora_rank, cfg.rope_head_dim
    h = cfg.n_heads

    if cfg.q_lora_rank:
        q = rmsnorm(x @ p["w_dq"], p["q_norm"], cfg.norm_eps) @ p["w_uq"]
    else:
        q = x @ p["w_q"]
    q = q.reshape(b, s, h, dh + rd)
    q_nope, q_rope = q[..., :dh], q[..., dh:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    dkv = x @ p["w_dkv"]                       # [b, s, r+rd]
    latent, k_rope = dkv[..., :r], dkv[..., r:]
    latent = rmsnorm(latent, p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)

    if cache is not None:
        idx = cache["index"]
        cl, cr = cache["latent"], cache["k_rope"]
        cl[:, idx:idx + s] = latent
        cr[:, idx:idx + s] = k_rope[:, :, 0, :]
        new_cache = {"latent": cl, "k_rope": cr, "index": idx + s}
        latent_all, k_rope_flat = cl, cr
        q_base = idx
    else:
        new_cache = None
        latent_all, k_rope_flat = latent, k_rope[:, :, 0, :]
        q_base = 0

    k_nope = (latent_all @ p["w_uk"]).reshape(b, -1, h, dh).float()
    v = (latent_all @ p["w_uv"]).reshape(b, -1, h, dh).float()
    k_rope_flat = k_rope_flat.float()
    sk = k_nope.shape[1]
    scale = 1.0 / math.sqrt(dh + rd)

    def block(qn: torch.Tensor, qr: torch.Tensor, offset: int):
        lg = (torch.einsum("bqhd,bkhd->bhqk", qn.float(), k_nope)
              + torch.einsum("bqhd,bkd->bhqk", qr.float(), k_rope_flat)
              ) * scale
        sq = qn.shape[1]
        qpos = q_base + offset + torch.arange(sq, device=x.device)[:, None]
        kpos = torch.arange(sk, device=x.device)[None, :]
        lg = torch.where(qpos >= kpos, lg, -1e30)
        probs = torch.softmax(lg, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", probs.to(x.dtype).float(), v)

    if s > SDPA_CHUNK and s % SDPA_CHUNK == 0 and cache is None:
        out = torch.cat([block(q_nope[:, i:i + SDPA_CHUNK],
                               q_rope[:, i:i + SDPA_CHUNK], i)
                         for i in range(0, s, SDPA_CHUNK)], dim=1)
    else:
        out = block(q_nope, q_rope, 0)
    out = out.to(x.dtype).reshape(b, s, h * dh)
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


# -- MoE ----------------------------------------------------------------------

def moe_init(gen: torch.Generator, cfg: ArchConfig,
             dtype: torch.dtype) -> Params:
    """The router, the experts' SwiGLU weights stacked on a leading expert
    axis ``[E, ...]``, and the shared experts as one wider MLP."""
    d = cfg.d_model
    ff = cfg.moe_d_ff or cfg.d_ff
    e = cfg.n_experts

    def stacked(d_in: int, d_out: int) -> torch.Tensor:
        w = torch.empty((e, d_in, d_out), dtype=dtype, device=gen.device)
        for i in range(e):
            w[i] = dense_init(gen, d_in, d_out, dtype)
        return w

    p = {"router": dense_init(gen, d, e, dtype, scale=0.02),
         "experts": {"w1": stacked(d, ff), "w3": stacked(d, ff),
                     "w2": stacked(ff, d)}}
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(gen, d, ff * cfg.n_shared_experts, dtype)
    return p


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k``: the ``k`` largest entries along the last axis in
    descending order, a tie going to the lower index (a stable sort;
    ``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_capacity(t: int, k: int, e: int,
                 capacity_factor: float = 1.25) -> int:
    """Slots per expert: drop-free (``t * k``) for up to 1024 routed
    (token, expert) pairs, so that prefill + decode and the full forward
    route alike on small batches; the capacity bound above."""
    return t * k if t * k <= 1024 else max(8, int(capacity_factor * t * k
                                                  / e))


@dataclasses.dataclass
class Routing:
    """One MoE layer's dispatch of ``T`` tokens: the router's fp32
    ``gates [T, E]``, the chosen experts ``flat_e [T*k]`` (token-major),
    their softmax weights ``probs [T, k]`` in the working type, each pair's
    slot in its expert's buffer and whether it fits (``keep``), and the
    ``capacity``."""
    gates: torch.Tensor
    flat_e: torch.Tensor
    probs: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    capacity: int


def moe_route(p: Params, cfg: ArchConfig, xf: torch.Tensor,
              capacity_factor: float = 1.25) -> Routing:
    """The reference's routing on ``xf [T, D]``: gates, top-k, a softmax
    over the top-k, and slot numbers from the exclusive prefix count of
    each expert over the token-major ``[T*k]`` order; a pair past the
    capacity is dropped and parked in the last slot."""
    t = xf.shape[0]
    k, e = cfg.experts_per_tok, cfg.n_experts
    gates = (xf @ p["router"]).float()                     # [T, E]
    top_vals, top_idx = top_k(gates, k)                    # [T, k]
    probs = torch.softmax(top_vals, dim=-1).to(xf.dtype)
    cap = moe_capacity(t, k, e, capacity_factor)
    flat_e = top_idx.reshape(-1)                           # [T*k]
    onehot = F.one_hot(flat_e, e)
    incl = torch.cumsum(onehot, dim=0)
    slot = torch.gather(incl - onehot, 1, flat_e[:, None])[:, 0]
    keep = slot < cap
    slot = torch.where(keep, slot, cap - 1)
    return Routing(gates, flat_e, probs, slot, keep, cap)


def moe_apply(p: Params, cfg: ArchConfig, x: torch.Tensor,
              capacity_factor: float = 1.25) -> torch.Tensor:
    """Top-k token-choice MoE with capacity-bounded dispatch: the JAX
    package's single-device path (``moe_route``, a scatter-add into
    ``[E, cap, D]`` buffers, the experts' batched products, the gather and
    the prob-weighted sum, then the shared experts)."""
    b, s, d = x.shape
    t = b * s
    k, e = cfg.experts_per_tok, cfg.n_experts
    xf = x.reshape(t, d)
    r = moe_route(p, cfg, xf, capacity_factor)

    x_rep = xf[:, None, :].expand(t, k, d).reshape(t * k, d)
    buf = torch.zeros((e, r.capacity, d), dtype=x.dtype, device=x.device)
    buf.index_put_((r.flat_e, r.slot),
                   torch.where(r.keep[:, None], x_rep, 0), accumulate=True)

    w = p["experts"]
    h = F.silu(torch.bmm(buf, w["w1"])) * torch.bmm(buf, w["w3"])
    out_e = torch.bmm(h, w["w2"])

    y = out_e[r.flat_e, r.slot] * r.keep[:, None].to(out_e.dtype)
    y = (y.reshape(t, k, d) * r.probs[..., None]).sum(dim=1)
    if cfg.n_shared_experts:
        y = y + mlp_apply(p["shared"], xf)
    return y.reshape(b, s, d)
