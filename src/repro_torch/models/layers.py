"""Transformer building blocks shared by the architectures.

The counterpart of the JAX package's ``repro/models/layers.py``, as
functions over plain dicts of tensors: RMSNorm, rotary embeddings (and
Qwen2-VL's multimodal M-RoPE), GQA attention (optional qk-norm,
cross-attention through ``kv_source``), DeepSeek-V2's multi-head latent
attention (MLA), the SwiGLU MLP and the top-k token-choice MoE with its
capacity-bounded dispatch.

Sharding is expressed as in the JAX package, by hints on the canonical
axes (batch/tokens -> ("pod", "data"), heads / ffn / experts -> "model"),
which the launcher binds with :func:`set_mesh_axes`.  A hint is a DTensor
``redistribute`` (``_maybe_shard``, :func:`shard_tokens`,
:func:`shard_model_last`) and does nothing to a plain tensor; DTensor's
sharding propagation places the rest and inserts the collectives that the
dry-run counts (:mod:`repro_torch.launch.costing`).  On DTensors the MoE
takes the reference's expert-parallel path (``_moe_routed_sharded``: each
rank runs ``_moe_dispatch_local`` on its tokens and its experts, then one
all-reduce over the model axis); on plain tensors, its single-device path.

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
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial

from repro_torch import spans
from repro_torch.kernels import ops
from repro_torch.launch.mesh import mesh_shape
from repro_torch.launch.sharding import _fit, placements
from repro_torch.models.config import ArchConfig

Params = Dict[str, Any]

# Mesh axis names used by the sharding hints; the launcher rebinds these to
# the active mesh (("pod","data") on the multi-pod mesh, ("data",) on the
# single-pod mesh, () when running unsharded).
_MESH_AXES = {"data": (), "model": None}


def set_mesh_axes(data_axes: Tuple[str, ...], model_axis: Optional[str]):
    _MESH_AXES["data"] = tuple(data_axes)
    _MESH_AXES["model"] = model_axis


def data_axes() -> Tuple[str, ...]:
    return _MESH_AXES["data"]


def model_axis() -> Optional[str]:
    return _MESH_AXES["model"]


def _maybe_shard(x: torch.Tensor, spec) -> torch.Tensor:
    """Sharding hint: ``x`` redistributed to ``spec`` (axis assignments
    that do not divide their dim dropped) if it is a DTensor, else ``x``."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    return x.redistribute(mesh, placements(_fit(mesh, x.shape, spec), mesh))


def shard_tokens(x: torch.Tensor) -> torch.Tensor:
    da = data_axes()
    if not da:
        return x
    if x.ndim >= 3 and model_axis():
        # activation sharding: batch over data axes, features over model
        return _maybe_shard(x, (da,) + (None,) * (x.ndim - 2)
                            + (model_axis(),))
    if x.ndim >= 2:
        return _maybe_shard(x, (da,) + (None,) * (x.ndim - 1))
    return x


def shard_model_last(x: torch.Tensor) -> torch.Tensor:
    da = data_axes()
    if not da or not model_axis():
        return x
    return _maybe_shard(x, (da,) + (None,) * (x.ndim - 2) + (model_axis(),))


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous: a gradient
    that leaves ``on_shards`` becomes a DTensor's local shard, which
    DTensor takes to be laid out as its global strides say."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def on_shards(fn, tensors, specs, out_spec, out_shape=None):
    """``fn(*tensors)``, run on each rank's shards when the tensors are
    DTensors: each is laid out by its spec (axis assignments that do not
    divide dropped), ``fn`` runs on the local tensors and its output is the
    DTensor of those shards laid out by ``out_spec``, fitted to
    ``out_shape`` (default: the first tensor's shape).  Attention is
    independent across batch rows and heads, so it runs whole on a rank's
    shards of both, where DTensor's per-op rules would split its products
    into strided layouts.  Plain tensors: ``fn(*tensors)``."""
    if not any(isinstance(t, DTensor) for t in tensors):
        return fn(*tensors)
    mesh = next(t.device_mesh for t in tensors if isinstance(t, DTensor))
    local = [_ContiguousGrad.apply(t.redistribute(
        mesh, placements(_fit(mesh, t.shape, spec), mesh)).to_local())
             for t, spec in zip(tensors, specs)]
    out_pl = placements(_fit(mesh, out_shape or tensors[0].shape, out_spec),
                        mesh)
    return DTensor.from_local(fn(*local), mesh, out_pl, run_check=False)


def heads_spec(x: torch.Tensor, groups: int) -> tuple:
    """The layout of ``[B, S, H, dh]`` heads run on shards: batch over the
    data axes, heads over the model axis where ``groups`` (the KV heads a
    fold keeps together) divides over it, else whole on each rank."""
    model = model_axis()
    if isinstance(x, DTensor) and model:
        mesh = x.device_mesh
        model = _fit(mesh, (groups,), (model,))[0]
    return (data_axes() or None, None, model, None)


def split_heads(x: torch.Tensor, heads: int, dh: int) -> torch.Tensor:
    """``x [B, S, heads * dh] -> [B, S, heads, dh]``.  A DTensor is first
    laid out as ``heads_spec`` lays out its heads: a view cannot split a
    dim whose shards would cut a head."""
    x = _maybe_shard(x, heads_spec(x, heads)[:3])
    return x.reshape(*x.shape[:2], heads, dh)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """``x [B, S, H, dh] -> [B, S, H * dh]``, laid out as ``split_heads``
    lays out its input: in the backward, the gradient takes that layout
    before its view back onto the heads."""
    b, s, h, dh = x.shape
    return _maybe_shard(x.reshape(b, s, h * dh), heads_spec(x, h)[:3])


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
    q = split_heads(x @ p["wq"], cfg.n_heads, dh)
    src = kv_source if kv_source is not None else x
    k = split_heads(src @ p["wk"], cfg.n_kv_heads, dh)
    v = split_heads(src @ p["wv"], cfg.n_kv_heads, dh)
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
    q = split_heads(shard_model_last(q.reshape(b, s, -1)), cfg.n_heads, dh)

    n_rep = cfg.n_heads // cfg.n_kv_heads
    if cache is not None:
        idx = cache["index"]
        ck, cv = cache["k"], cache["v"]
        ck[:, idx:idx + s] = k
        cv[:, idx:idx + s] = v
        new_cache = {"k": ck, "v": cv, "index": idx + s}
        if idx == 0 and s > 1:
            out = _sdpa_on_shards(q, _repeat_kv(k, n_rep),
                                  _repeat_kv(v, n_rep), True, flash)
        else:
            spec = heads_spec(q, cfg.n_kv_heads)
            out = on_shards(
                lambda q_, k_, v_: _cached_attention(q_, k_, v_, idx),
                (q, ck, cv), (spec,) * 3, spec)
    else:
        out = _sdpa_on_shards(q, _repeat_kv(k, n_rep), _repeat_kv(v, n_rep),
                              causal and kv_source is None, flash)
        new_cache = None
    return merge_heads(out) @ p["wo"], new_cache


def _sdpa_on_shards(q, k, v, causal: bool, flash: bool):
    """``_sdpa`` on each rank's batch rows and heads (``on_shards``)."""
    spec = heads_spec(q, q.shape[2])
    return on_shards(lambda q_, k_, v_: _sdpa(q_, k_, v_, causal, flash),
                     (q, k, v), (spec,) * 3, spec)


def _cached_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                      idx: int) -> torch.Tensor:
    """q [B,S,H,dh] at positions ``idx..`` over the whole cache ck, cv
    [B,Smax,Hkv,dh] under the causal mask: the group dim folded into q, the
    cache read once; products of the working type summed in fp32 (JAX:
    ``preferred_element_type``)."""
    b, s, h, dh = q.shape
    n_kv = ck.shape[2]
    qg = q.reshape(b, s, n_kv, h // n_kv, dh)
    smax = ck.shape[1]
    kpos = torch.arange(smax, device=q.device)[None, :]
    qpos = idx + torch.arange(s, device=q.device)[:, None]
    mask = kpos <= qpos          # causal over the filled prefix
    if spans.on() and ck.dtype != torch.float32:
        # the fp32 copies of the whole cache ``.float()`` makes below
        spans.count("attn.cast_bytes", (ck.numel() + cv.numel()) * 4)
    logits = torch.einsum("bqhrd,bkhd->bhrqk", qg.float(),
                          ck.float()) / math.sqrt(dh)
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs.to(q.dtype).float(),
                       cv.float())
    return out.reshape(b, s, h, dh).to(q.dtype)


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
    q = split_heads(q, h, dh + rd)
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

    if data_axes():
        # the latent rows whole on each rank of the model axis (a cache
        # holds its sequence there): a product over rows merged from two
        # sharded dims would take DTensor a strided layout
        latent_all = _maybe_shard(latent_all, (data_axes(), None, None))
    k_nope = split_heads(latent_all @ p["w_uk"], h, dh)
    v = split_heads(latent_all @ p["w_uv"], h, dh)
    chunked = s > SDPA_CHUNK and s % SDPA_CHUNK == 0 and cache is None
    spec = heads_spec(q_nope, h)
    out = on_shards(
        lambda qn, qr, kn, kr, v_: _mla_scores(qn, qr, kn, kr, v_, q_base,
                                               chunked),
        (q_nope, q_rope, k_nope, k_rope_flat, v),
        (spec, spec, spec, spec[:2] + (None,), spec), spec)
    return merge_heads(out) @ p["wo"], new_cache


def _mla_scores(q_nope: torch.Tensor, q_rope: torch.Tensor,
                k_nope: torch.Tensor, k_rope: torch.Tensor, v: torch.Tensor,
                q_base: int, chunked: bool) -> torch.Tensor:
    """MLA's attention of q [B,S,H,dh] (+ its rope part [B,S,H,rd]) at
    positions ``q_base..`` over keys [B,Sk,H,dh] (+ the shared rope key
    [B,Sk,rd]) and values [B,Sk,H,dh] under the causal mask, in q-row
    blocks of ``SDPA_CHUNK`` when ``chunked``; returns [B,S,H,dh] in q's
    type."""
    dtype = q_nope.dtype
    s, dh, rd = q_nope.shape[1], q_nope.shape[-1], q_rope.shape[-1]
    k_nope, v, k_rope = k_nope.float(), v.float(), k_rope.float()
    sk = k_nope.shape[1]
    scale = 1.0 / math.sqrt(dh + rd)

    def block(qn: torch.Tensor, qr: torch.Tensor, offset: int):
        lg = (torch.einsum("bqhd,bkhd->bhqk", qn.float(), k_nope)
              + torch.einsum("bqhd,bkd->bhqk", qr.float(), k_rope)
              ) * scale
        sq = qn.shape[1]
        qpos = q_base + offset + torch.arange(sq, device=qn.device)[:, None]
        kpos = torch.arange(sk, device=qn.device)[None, :]
        lg = torch.where(qpos >= kpos, lg, -1e30)
        probs = torch.softmax(lg, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", probs.to(dtype).float(), v)

    if chunked:
        out = torch.cat([block(q_nope[:, i:i + SDPA_CHUNK],
                               q_rope[:, i:i + SDPA_CHUNK], i)
                         for i in range(0, s, SDPA_CHUNK)], dim=1)
    else:
        out = block(q_nope, q_rope, 0)
    return out.to(dtype)


# -- MLP ----------------------------------------------------------------------

def mlp_init(gen: torch.Generator, d: int, d_ff: int,
             dtype: torch.dtype) -> Params:
    return {"w1": dense_init(gen, d, d_ff, dtype),
            "w3": dense_init(gen, d, d_ff, dtype),
            "w2": dense_init(gen, d_ff, d, dtype)}


def mlp_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ p["w1"]) * (x @ p["w3"])
    h = shard_model_last(h)
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


def _gate(p: Params, cfg: ArchConfig, xf: torch.Tensor):
    """Router gates in fp32 ``[T, E]``, the top-k experts ``[T, k]`` and
    the softmax over their gates in the working type."""
    gates = (xf @ p["router"]).float()                     # [T, E]
    top_vals, top_idx = top_k(gates, cfg.experts_per_tok)  # [T, k]
    probs = torch.softmax(top_vals, dim=-1).to(xf.dtype)
    return gates, top_idx, probs


def moe_route(p: Params, cfg: ArchConfig, xf: torch.Tensor,
              capacity_factor: float = 1.25) -> Routing:
    """The reference's routing on ``xf [T, D]``: gates, top-k, a softmax
    over the top-k, and slot numbers from the exclusive prefix count of
    each expert over the token-major ``[T*k]`` order; a pair past the
    capacity is dropped and parked in the last slot."""
    t = xf.shape[0]
    k, e = cfg.experts_per_tok, cfg.n_experts
    gates, top_idx, probs = _gate(p, cfg, xf)
    cap = moe_capacity(t, k, e, capacity_factor)
    flat_e = top_idx.reshape(-1)                           # [T*k]
    onehot = F.one_hot(flat_e, e)
    incl = torch.cumsum(onehot, dim=0)
    slot = torch.gather(incl - onehot, 1, flat_e[:, None])[:, 0]
    keep = slot < cap
    slot = torch.where(keep, slot, cap - 1)
    return Routing(gates, flat_e, probs, slot, keep, cap)


def _moe_dispatch_local(cfg: ArchConfig, capacity_factor: float):
    """The per-device MoE dispatch body of the expert-parallel path (the
    JAX package's ``shard_map`` body).

    ``body(xf, top_idx, probs, w1, w3, w2, model_index)``: this rank's
    tokens ``xf [T_loc, D]`` with their top-k experts and weights, and its
    ``E / model_size`` experts, the ``model_index``-th block of them.  It
    routes the local tokens to the local experts with the capacity
    ``max(8, int(capacity_factor * T_loc * k / E))`` (no drop-free branch),
    runs the experts' products on local buffers and returns this rank's
    share of the output ``[T_loc, D]``; the caller sums the shares over the
    model axis (the reference's ``psum``)."""
    e_total = cfg.n_experts
    k = cfg.experts_per_tok

    def body(xf, top_idx, probs, w1, w3, w2, model_index: int):
        e_loc = w1.shape[0]
        t_loc, d = xf.shape
        e_start = model_index * e_loc
        cap = max(8, int(capacity_factor * t_loc * k / e_total))
        flat_e = top_idx.reshape(-1).long() - e_start
        mine = (flat_e >= 0) & (flat_e < e_loc)
        fe = torch.where(mine, flat_e, 0)
        onehot = F.one_hot(fe, e_loc) * mine[:, None]
        incl = torch.cumsum(onehot, dim=0)
        slot = torch.gather(incl - onehot, 1, fe[:, None])[:, 0]
        keep = mine & (slot < cap)
        slot = torch.where(keep, slot, cap - 1)
        x_rep = xf[:, None, :].expand(t_loc, k, d).reshape(t_loc * k, d)
        buf = xf.new_zeros((e_loc, cap, d))
        buf.index_put_((fe, slot), torch.where(keep[:, None], x_rep, 0),
                       accumulate=True)
        h = F.silu(torch.bmm(buf, w1)) * torch.bmm(buf, w3)
        out_e = torch.bmm(h, w2)
        y = out_e[fe, slot] * keep[:, None].to(out_e.dtype)
        return (y.reshape(t_loc, k, d)
                * probs.reshape(t_loc, k)[..., None].to(y.dtype)).sum(1)

    return body


def _moe_routed_sharded(p: Params, cfg: ArchConfig, xf: torch.Tensor,
                        top_idx: torch.Tensor, probs: torch.Tensor,
                        capacity_factor: float) -> Optional[torch.Tensor]:
    """The expert-parallel path on DTensors; None where it does not apply
    (a plain tensor, no data or model axis, experts or tokens that do not
    divide over it), and the caller takes the single-device path.

    Tokens go over the data axes and are replicated along the model axis,
    the experts over the model axis (gathered along the data axes); each
    rank runs ``_moe_dispatch_local`` on its local tensors, and its share
    becomes a partial sum over the model axis, which one all-reduce (a
    functional collective) turns into the output."""
    model_ax, da = model_axis(), data_axes()
    if not model_ax or not da or not isinstance(xf, DTensor):
        return None
    mesh = xf.device_mesh
    sizes = mesh_shape(mesh)
    if model_ax not in sizes:
        return None
    dsize = math.prod(sizes[a] for a in da)
    if cfg.n_experts % sizes[model_ax] or xf.shape[0] % dsize:
        return None
    tok = placements((da, None), mesh)
    exp = placements((model_ax, None, None), mesh)

    def local(t: torch.Tensor, where) -> torch.Tensor:
        return t.redistribute(mesh, where).to_local()

    w = p["experts"]
    body = _moe_dispatch_local(cfg, capacity_factor)
    y = body(local(xf, tok), local(top_idx, tok), local(probs, tok),
             local(w["w1"], exp), local(w["w3"], exp), local(w["w2"], exp),
             mesh.get_local_rank(model_ax))
    share = tuple(Partial() if name == model_ax else pl
                  for name, pl in zip(mesh.mesh_dim_names, tok))
    return DTensor.from_local(y, mesh, share, run_check=False).redistribute(
        mesh, tok)


def moe_apply(p: Params, cfg: ArchConfig, x: torch.Tensor,
              capacity_factor: float = 1.25) -> torch.Tensor:
    """Top-k token-choice MoE with capacity-bounded dispatch.  On DTensors
    with a model axis bound, the expert-parallel path
    (``_moe_routed_sharded``); otherwise the JAX package's single-device
    path (``moe_route``, a scatter-add into ``[E, cap, D]`` buffers, the
    experts' batched products, the gather and the prob-weighted sum).  The
    shared experts follow either."""
    b, s, d = x.shape
    t = b * s
    k, e = cfg.experts_per_tok, cfg.n_experts
    # the tokens over the data axes: so laid out, the flat rows' gradient
    # views back onto [B, S] (rows sharded over every mesh axis would not)
    xf = shard_tokens(x.reshape(t, d))

    y = None
    if model_axis() and isinstance(xf, DTensor):
        _, top_idx, probs = _gate(p, cfg, xf)
        y = _moe_routed_sharded(p, cfg, xf, top_idx, probs, capacity_factor)
    if y is None:
        r = moe_route(p, cfg, xf, capacity_factor)
        x_rep = xf[:, None, :].expand(t, k, d).reshape(t * k, d)
        buf = xf.new_zeros((e, r.capacity, d))
        buf.index_put_((r.flat_e, r.slot),
                       torch.where(r.keep[:, None], x_rep, 0),
                       accumulate=True)
        if model_axis():
            buf = _maybe_shard(buf, (model_axis(), data_axes() or None,
                                     None))

        w = p["experts"]
        h = F.silu(torch.bmm(buf, w["w1"])) * torch.bmm(buf, w["w3"])
        out_e = torch.bmm(h, w["w2"])

        y = out_e[r.flat_e, r.slot] * r.keep[:, None].to(out_e.dtype)
        y = (y.reshape(t, k, d) * r.probs[..., None]).sum(dim=1)
    if cfg.n_shared_experts:
        y = y + mlp_apply(p["shared"], xf)
    return y.reshape(b, s, d)
