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

Attention outside the kernel keeps the JAX package's numbers, written
once: each site sums its scores of the working type's operands in fp32
(cast to fp32: bf16 products are exact there), then -1e30 under the
causal mask, an fp32 softmax (``_softmax``), and the probabilities cast
to the working type for the product with v, summed in fp32 (``_attend``;
the absorbed MLA decode multiplies them by the latent in the working
type).  Over a whole sequence (``_sdpa``) the caller's ``flash`` chooses:
serving goes through the hand-written flash-attention kernel
(:func:`repro_torch.kernels.ops.flash_attention`, the JAX package's K6),
which the JAX package's docstring names as the replacement of its chunked
einsum path on real hardware.  In fp32 the two agree to rounding; in bf16
the kernel also rounds the probabilities to bf16, but normalises by the
sum of the rounded weights where the einsum path normalises first: the
two agree within the bf16 tolerance of ``kernels/ref.py``.  Training
(``flash=False``) takes the einsum path in q-row blocks (``_q_blocks``):
K6 has no backward there either, and refuses autograd here.  MLA never
reaches ``_sdpa`` in the reference (its q·k width, dh + ``rope_head_dim``,
is not v's); here a served prompt goes through the kernel where it is
built for MLA's pair of widths (bf16 at 192 and 128), and MLA otherwise
keeps the reference's masked einsum product (``mla_attention``).

DeepSeek-V2's own routing (``group_limited_route``) and the share of an
expert-parallel layer that one device computes (``moe_held_apply``) serve
a config with the port's ``router_experts`` field.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch import spans
from repro_torch.kernels import ops
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


def mesh_shape(mesh: DeviceMesh) -> dict:
    """{axis name: extent}, as ``jax.sharding.Mesh.shape``."""
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def axis_size(mesh: DeviceMesh, entry) -> int:
    if entry is None:
        return 1
    sizes = mesh_shape(mesh)
    if isinstance(entry, tuple):
        return math.prod(sizes[e] for e in entry)
    return sizes[entry]


def fit_spec(mesh: DeviceMesh, shape, spec_entries) -> tuple:
    """Drop axis assignments whose mesh extent does not divide the dim."""
    out = []
    for dim, entry in zip(shape, spec_entries):
        if entry is None:
            out.append(None)
            continue
        size = axis_size(mesh, entry)
        out.append(entry if dim % size == 0 else None)
    return tuple(out)


def placements(spec, mesh: DeviceMesh) -> tuple:
    """DTensor placements of ``spec``: for each mesh dim, ``Shard(d)`` of
    the tensor dim ``d`` whose entry names it, else ``Replicate()``."""
    out = []
    for axis in mesh.mesh_dim_names:
        dims = [d for d, entry in enumerate(spec)
                if entry == axis or (isinstance(entry, tuple)
                                     and axis in entry)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def _maybe_shard(x: torch.Tensor, spec) -> torch.Tensor:
    """Sharding hint: ``x`` redistributed to ``spec`` (axis assignments
    that do not divide their dim dropped) if it is a DTensor, else ``x``."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    return x.redistribute(mesh, placements(fit_spec(mesh, x.shape, spec),
                                           mesh))


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
        mesh, placements(fit_spec(mesh, t.shape, spec), mesh)).to_local())
             for t, spec in zip(tensors, specs)]
    out_pl = placements(fit_spec(mesh, out_shape or tensors[0].shape,
                                 out_spec), mesh)
    return DTensor.from_local(fn(*local), mesh, out_pl, run_check=False)


def heads_spec(x: torch.Tensor, groups: int) -> tuple:
    """The layout of ``[B, S, H, dh]`` heads run on shards: batch over the
    data axes, heads over the model axis where ``groups`` (the KV heads a
    fold keeps together) divides over it, else whole on each rank."""
    model = model_axis()
    if isinstance(x, DTensor) and model:
        mesh = x.device_mesh
        model = fit_spec(mesh, (groups,), (model,))[0]
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


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention factor ``0.1 m ln s + 1`` (1 at a factor <= 1)."""
    return 0.1 * mscale * math.log(factor) + 1.0 if factor > 1 else 1.0


@functools.lru_cache(maxsize=8)
def yarn_freqs(cfg: ArchConfig, dim: int,
               device: torch.device | str = "cpu") -> torch.Tensor:
    """DeepSeek-V2's YaRN frequencies of a rotary part of width ``dim``
    (float64): ``f_e m + f_e / s (1 - m)``, ``f_e`` RoPE's, ``s`` the
    factor, ``m`` 1 less a linear ramp over the frequency index from
    ``floor(c(beta_fast))`` to ``ceil(c(beta_slow))`` clamped to [0, 1],
    ``c(n) = dim ln(L / (2 pi n)) / (2 ln theta)`` at the original
    context ``L``.  Made on the device once a config (a decode step would
    make them again in every layer)."""
    f_e = rope_freqs(dim, cfg.rope_theta, device)

    def c(n: float) -> float:
        return (dim * math.log(cfg.yarn_original_max / (n * 2 * math.pi))
                / (2 * math.log(cfg.rope_theta)))

    low = max(math.floor(c(cfg.yarn_beta_fast)), 0)
    high = min(math.ceil(c(cfg.yarn_beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float64, device=device)
             - low) / (high - low)).clamp(0, 1)
    m = 1.0 - ramp
    return f_e * m + f_e / cfg.yarn_factor * (1.0 - m)


def mla_rope(cfg: ArchConfig, device: torch.device | str = "cpu"
             ) -> Tuple[torch.Tensor, float]:
    """MLA's rotary frequencies (float64) and the factor on its cos and
    sin: YaRN's where ``cfg.yarn_factor`` is set, else RoPE's and 1."""
    rd = cfg.rope_head_dim
    if not cfg.yarn_factor:
        return rope_freqs(rd, cfg.rope_theta, device), 1.0
    return (yarn_freqs(cfg, rd, device),
            yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale)
            / yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim))


def mla_softmax_scale(cfg: ArchConfig) -> float:
    """``(dh + rope_head_dim)^-1/2``, times YaRN's attention factor
    squared where the config scales its rotary part (DeepSeek-V2)."""
    scale = 1.0 / math.sqrt(cfg.head_dim + cfg.rope_head_dim)
    if cfg.yarn_factor and cfg.yarn_mscale_all_dim:
        scale *= yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim) ** 2
    return scale


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0,
               freqs: Optional[torch.Tensor] = None,
               mscale: float = 1.0) -> torch.Tensor:
    """x [..., S, H, dh]; positions [..., S] (int).  ``freqs``: the
    frequencies to rotate by (default RoPE's at ``theta``); ``mscale``
    multiplies cos and sin."""
    dh = x.shape[-1]
    if freqs is None:
        freqs = rope_freqs(dh, theta, x.device)
    freqs = freqs.float()
    ang = positions[..., None].float() * freqs               # [..., S, dh/2]
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    if mscale != 1.0:
        cos, sin = cos * mscale, sin * mscale
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


def _causal_mask(q0, sq: int, sk: int, device) -> torch.Tensor:
    """``[sq, sk]``: key position <= query position, queries at ``q0..``
    (an int or a 0-d tensor on ``device``, never read on the host)."""
    kpos = torch.arange(sk, device=device)[None, :]
    qpos = q0 + torch.arange(sq, device=device)[:, None]
    return kpos <= qpos


def _softmax(logits: torch.Tensor, mask) -> torch.Tensor:
    """The fp32 softmax over the last dim of fp32 ``logits``, -1e30 where
    ``mask`` (if given) is false."""
    if mask is not None:
        logits = torch.where(mask, logits, -1e30)
    return torch.softmax(logits, dim=-1)


def _attend(eq: str, logits: torch.Tensor, mask: Optional[torch.Tensor],
            v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The product of ``_softmax(logits, mask)``, cast to ``dtype``, with
    v, by the einsum ``eq``, summed and returned in fp32."""
    probs = _softmax(logits, mask)
    return torch.einsum(eq, probs.to(dtype).float(), v.float())


def _q_blocks(block, qs) -> torch.Tensor:
    """``block(*qs, 0)``; queries longer than ``SDPA_CHUNK`` and a multiple
    of it go in q-row blocks (the JAX package's ``lax.scan``), ``block``
    given each block's rows of ``qs`` and its first row's offset, so that
    only [B,H,C,Sk] scores exist at a time."""
    s = qs[0].shape[1]
    if s <= SDPA_CHUNK or s % SDPA_CHUNK != 0:
        return block(*qs, 0)
    return torch.cat([block(*(q[:, i:i + SDPA_CHUNK] for q in qs), i)
                      for i in range(0, s, SDPA_CHUNK)], dim=1)


def _sdpa_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, q_offset: int) -> torch.Tensor:
    """The JAX package's ``_sdpa_block``: q [B,C,H,dh] at positions
    ``q_offset..`` over k, v [B,Sk,H,dh]."""
    dh = q.shape[-1]
    scale = 1.0 / math.sqrt(dh)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = (_causal_mask(q_offset, q.shape[1], k.shape[1], q.device)
            if causal else None)
    return _attend("bhqk,bkhd->bqhd", logits, mask, v, q.dtype).to(q.dtype)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          causal: bool, flash: bool) -> torch.Tensor:
    """q [B,Sq,H,dh], k/v [B,Sk,H,dh] -> [B,Sq,H,dh]; the causal mask is
    aligned top-left.

    ``flash``: through the flash-attention kernel, which never forms the
    [Sq, Sk] scores.  Otherwise the JAX package's einsum path, in q-row
    blocks (``_q_blocks``)."""
    b, sq, h, dh = q.shape
    if not flash:
        return _q_blocks(
            lambda q_, i: _sdpa_block(q_, k, v, causal, i), (q,))
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

    ``cache``: {"k","v" [B,Smax,Hkv,dh], "index" int or 0-d int64 tensor
    on the cache's device} — the new keys and values are written into the
    cache tensors in place (where JAX returns updated copies) at
    ``index``; the returned cache holds the same tensors and ``index +
    S``.  A prompt written at index 0 attends over its own keys through
    the kernel, which equals the JAX package's softmax over all cache
    slots (the empty ones weigh exactly 0); any other step (decode) takes
    the masked product over the cache, as in JAX.  That choice tests
    ``S > 1`` before it looks at the index (``model.decode_step``).
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
        new_cache = {"k": ck, "v": cv, "index": idx + s}
        _write_at(ck, idx, k)
        _write_at(cv, idx, v)
        if s > 1 and idx == 0:
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


def _write_at(cache: torch.Tensor, idx, new: torch.Tensor) -> None:
    """``cache[:, idx:idx + S] = new``: a slice copy at an int ``idx`` or
    on a DTensor (torch 2.11's has no rule for ``index_copy_``), else
    ``index_copy_`` at a 0-d tensor ``idx``, which stays on the device."""
    if isinstance(idx, int) or isinstance(cache, DTensor):
        cache[:, idx:idx + new.shape[1]] = new
    else:
        cache.index_copy_(1, idx + torch.arange(new.shape[1],
                                                device=cache.device), new)


def _sdpa_on_shards(q, k, v, causal: bool, flash: bool):
    """``_sdpa`` on each rank's batch rows and heads (``on_shards``)."""
    spec = heads_spec(q, q.shape[2])
    return on_shards(lambda q_, k_, v_: _sdpa(q_, k_, v_, causal, flash),
                     (q, k, v), (spec,) * 3, spec)


def _cached_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                      idx) -> torch.Tensor:
    """q [B,S,H,dh] at positions ``idx..`` (an int or a 0-d tensor on
    q's device) over the whole cache ck, cv [B,Smax,Hkv,dh] under the
    causal mask: the group dim folded into q, the cache read once."""
    b, s, h, dh = q.shape
    n_kv = ck.shape[2]
    qg = q.reshape(b, s, n_kv, h // n_kv, dh)
    mask = _causal_mask(idx, s, ck.shape[1], q.device)
    if spans.on() and ck.dtype != torch.float32:
        # the fp32 copies of the whole cache ``.float()`` makes below
        spans.count("attn.cast_bytes", (ck.numel() + cv.numel()) * 4)
    logits = torch.einsum("bqhrd,bkhd->bhrqk", qg.float(),
                          ck.float()) / math.sqrt(dh)
    out = _attend("bhrqk,bkhd->bqhrd", logits, mask, cv, q.dtype)
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
                  positions: torch.Tensor, cache: Optional[Dict] = None,
                  flash: bool = True):
    """Multi-head latent attention: KV compressed to ``kv_lora_rank`` (the
    cache stores only the r + ``rope_head_dim`` latent), the rotary part
    by RoPE, or by YaRN where the config scales it (``mla_rope``,
    ``mla_softmax_scale``).

    ``cache``: {"latent" [B,Smax,r], "k_rope" [B,Smax,rd], "index" int
    or 0-d int64 tensor on the cache's device}, written in place at
    ``index``.  On plain tensors a cache takes the serving paths: a
    one-token step, or any step at a tensor index, goes through the
    absorbed form (``_mla_absorbed``), which reads the whole latent cache
    under the causal mask, up-projects nothing of its length and reads
    no index on the host, so that a CUDA graph of it replays at any
    position; a prompt written at int index 0 attends through the
    flash-attention kernel when ``flash`` and the kernel is built for its
    widths (``_mla_prefill``: q·k at depth dh + rd, v of width dh;
    DeepSeek-V2's 192 and 128, on the card in bf16); a longer step at a
    later int index, through the absorbed form too.  Otherwise (no cache,
    ``flash`` off, or DTensors) the JAX package's product: keys and
    values up-projected per head from every latent row, attention over
    every cache slot under the causal mask, and without a cache in q-row
    blocks (``_q_blocks``)."""
    with spans.span("mla"):
        return _mla_attention(p, cfg, x, positions, cache, flash)


def _mla_attention(p: Params, cfg: ArchConfig, x: torch.Tensor,
                   positions: torch.Tensor, cache: Optional[Dict],
                   flash: bool):
    b, s, _ = x.shape
    dh, r, rd = cfg.head_dim, cfg.kv_lora_rank, cfg.rope_head_dim
    h = cfg.n_heads
    freqs, mscale = mla_rope(cfg, x.device)
    scale = mla_softmax_scale(cfg)

    if cfg.q_lora_rank:
        q = rmsnorm(x @ p["w_dq"], p["q_norm"], cfg.norm_eps) @ p["w_uq"]
    else:
        q = x @ p["w_q"]
    q = split_heads(q, h, dh + rd)
    q_nope, q_rope = q[..., :dh], q[..., dh:]
    q_rope = apply_rope(q_rope, positions, freqs=freqs, mscale=mscale)

    dkv = x @ p["w_dkv"]                       # [b, s, r+rd]
    latent, k_rope = dkv[..., :r], dkv[..., r:]
    latent = rmsnorm(latent, p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, freqs=freqs,
                        mscale=mscale)

    if cache is not None:
        idx = cache["index"]
        cl, cr = cache["latent"], cache["k_rope"]
        _write_at(cl, idx, latent)
        _write_at(cr, idx, k_rope[:, :, 0, :])
        new_cache = {"latent": cl, "k_rope": cr, "index": idx + s}
        plain = not isinstance(x, DTensor)
        item = cl.element_size()
        # a one-token step, or any at a tensor index, is decided before
        # the index is looked at (``model.decode_step``)
        if plain and (s == 1 or not isinstance(idx, int) or idx > 0):
            with spans.span("mla.decode_attn"):
                out = _mla_absorbed(p, q_nope, q_rope, cl, cr, idx, scale)
            # the whole latent and rope cache, at any index
            spans.count("mla.cache_bytes", b * cl.shape[1] * (r + rd)
                        * item)
            return merge_heads(out) @ p["wo"], new_cache
        if plain and flash and ops.flash_attention_takes(
                dh + rd, dh, x.dtype, x.device):
            with spans.span("mla.prefill_attn"):
                out = _mla_prefill(p, q_nope, q_rope, latent,
                                   k_rope[:, :, 0, :], scale)
            # the per-head keys and values it makes of the prompt
            spans.count("mla.cache_bytes", b * s * h * (2 * dh + rd) * item)
            return merge_heads(out) @ p["wo"], new_cache
        latent_all, k_rope_flat = cl, cr
        q_base = idx
        if spans.on():
            # the whole cache read, and keys and values made over its length
            spans.count("mla.cache_bytes", cl.shape[0] * cl.shape[1]
                        * (r + rd + 2 * h * dh) * cl.element_size())
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
    spec = heads_spec(q_nope, h)
    out = on_shards(
        lambda qn, qr, kn, kr, v_: _mla_scores(
            qn, qr, kn, kr, v_, q_base, cache is not None, scale),
        (q_nope, q_rope, k_nope, k_rope_flat, v),
        (spec, spec, spec, spec[:2] + (None,), spec), spec)
    return merge_heads(out) @ p["wo"], new_cache


def _mla_prefill(p: Params, q_nope: torch.Tensor, q_rope: torch.Tensor,
                 latent: torch.Tensor, k_rope: torch.Tensor,
                 scale: float) -> torch.Tensor:
    """A prompt's causal attention through the flash-attention kernel: q
    ``[q_nope | q_rope]`` and k ``[k_nope | k_rope]`` (the rope key shared
    by every head) at depth dh + rd, v of width dh, each laid out
    ``[B·H, S, ·]`` by one copy; returns ``[B, S, H, dh]``."""
    b, s, h, dh = q_nope.shape
    rd = q_rope.shape[-1]
    qh = q_nope.new_empty((b, h, s, dh + rd))
    qh[..., :dh] = q_nope.transpose(1, 2)
    qh[..., dh:] = q_rope.transpose(1, 2)
    kh = q_nope.new_empty((b, h, s, dh + rd))
    kh[..., :dh] = (latent @ p["w_uk"]).view(b, s, h, dh).transpose(1, 2)
    kh[..., dh:] = k_rope[:, None]
    vh = (latent @ p["w_uv"]).view(b, s, h, dh).transpose(1, 2).reshape(
        b * h, s, dh)
    out = ops.flash_attention(qh.view(b * h, s, dh + rd),
                              kh.view(b * h, s, dh + rd), vh, causal=True,
                              scale=scale)
    return out.view(b, h, s, dh).transpose(1, 2)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (batched) of the working type's operands, summed and
    returned in fp32: cuBLAS's fp32 output on the card, the operands cast
    elsewhere (the CPU has no such product)."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _mla_absorbed(p: Params, q_nope: torch.Tensor, q_rope: torch.Tensor,
                  cl: torch.Tensor, cr: torch.Tensor, idx,
                  scale: float) -> torch.Tensor:
    """q ``[B,S,H,dh]`` (+ rope part ``[B,S,H,rd]``) at positions
    ``idx..`` (an int or a 0-d tensor on q's device, never read on the
    host) over the whole cache ``cl``, ``cr`` ``[B,Smax,·]`` in the
    absorbed form: ``w_uk`` folded into q (``q_lat = q_nope w_ukᵀ`` per
    head, ``[B,H,S,r]``), scores ``q_lat·latent + q_rope·k_rope`` summed
    in fp32, the causal mask (the slots past the new rows weigh exactly
    0), ``o_lat = p·latent`` of the working type, and ``w_uv`` applied to
    ``o_lat`` per head; returns ``[B,S,H,dh]`` in q's type."""
    b, s, h, dh = q_nope.shape
    n, r, rd = cl.shape[1], cl.shape[-1], cr.shape[-1]
    w_uk = p["w_uk"].view(r, h, dh)
    q_lat = torch.einsum("bshd,rhd->bhsr", q_nope, w_uk).reshape(b, h * s,
                                                                  r)
    q_r = q_rope.transpose(1, 2).reshape(b, h * s, rd)
    scores = (_bmm_f32(q_r, cr.transpose(1, 2))
              + _bmm_f32(q_lat, cl.transpose(1, 2)))
    lg = scores.view(b, h, s, n) * scale
    probs = _softmax(lg, _causal_mask(idx, s, n, lg.device)).to(
        q_nope.dtype).view(b, h * s, n)
    o_lat = torch.bmm(probs, cl).view(b, h, s, r)
    return torch.einsum("bhsr,rhd->bshd", o_lat, p["w_uv"].view(r, h, dh))


def _mla_scores(q_nope: torch.Tensor, q_rope: torch.Tensor,
                k_nope: torch.Tensor, k_rope: torch.Tensor, v: torch.Tensor,
                q_base: int, cached: bool, scale: float) -> torch.Tensor:
    """MLA's attention of q [B,S,H,dh] (+ its rope part [B,S,H,rd]) at
    positions ``q_base..`` over keys [B,Sk,H,dh] (+ the shared rope key
    [B,Sk,rd]) and values [B,Sk,H,dh] under the causal mask, in q-row
    blocks (``_q_blocks``) unless ``cached``; returns [B,S,H,dh] in q's
    type."""
    dtype = q_nope.dtype
    k_nope, v, k_rope = k_nope.float(), v.float(), k_rope.float()
    sk = k_nope.shape[1]

    def block(qn: torch.Tensor, qr: torch.Tensor, offset: int):
        lg = (torch.einsum("bqhd,bkhd->bhqk", qn.float(), k_nope)
              + torch.einsum("bqhd,bkd->bhqk", qr.float(), k_rope)
              ) * scale
        mask = _causal_mask(q_base + offset, qn.shape[1], sk, qn.device)
        return _attend("bhqk,bkhd->bqhd", lg, mask, v, dtype)

    qs = (q_nope, q_rope)
    out = block(*qs, 0) if cached else _q_blocks(block, qs)
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
    """The router (over ``router_experts`` where set), the held experts'
    SwiGLU weights stacked on a leading expert axis ``[E, ...]``, and the
    shared experts as one wider MLP."""
    d = cfg.d_model
    ff = cfg.moe_d_ff or cfg.d_ff
    e = cfg.n_experts

    def stacked(d_in: int, d_out: int) -> torch.Tensor:
        w = torch.empty((e, d_in, d_out), dtype=dtype, device=gen.device)
        for i in range(e):
            w[i] = dense_init(gen, d_in, d_out, dtype)
        return w

    p = {"router": dense_init(gen, d, cfg.router_experts or e, dtype,
                              scale=0.02),
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


def group_limited_route(p: Params, cfg: ArchConfig, xf: torch.Tensor):
    """DeepSeek-V2's routing of ``xf [T, D]`` over ``router_experts``:
    ``scores`` the fp32 softmax of the router's logits (computed from the
    working type's operands in fp32); with groups, each group scored by
    its best expert and all but the ``topk_group`` best groups zeroed;
    the ``experts_per_tok`` largest scores left (ties to the lower index),
    each weighted by its score times ``routed_scaling``, not renormalised.
    Returns ``(scores [T, E_r], top_idx [T, k], weights [T, k] fp32)``."""
    scores = torch.softmax(xf.float() @ p["router"].float(), dim=-1)
    chosen = scores
    if cfg.n_group > 1:
        t, e = scores.shape
        groups = scores.view(t, cfg.n_group, e // cfg.n_group)
        _, keep = top_k(groups.amax(-1), cfg.topk_group)
        mask = torch.zeros(t, cfg.n_group, dtype=torch.bool,
                           device=xf.device).scatter_(1, keep, True)
        chosen = torch.where(mask[..., None], groups, 0.0).view(t, e)
    top_vals, top_idx = top_k(chosen, cfg.experts_per_tok)
    return scores, top_idx, top_vals * cfg.routed_scaling


def moe_held_apply(p: Params, cfg: ArchConfig, x: torch.Tensor
                   ) -> torch.Tensor:
    """One device's share of an expert-parallel MoE layer: every token
    routed over all ``router_experts`` (``group_limited_route``), the
    (token, expert) pairs whose expert this device holds (``[offset,
    offset + n_experts)``) each through its expert, with no capacity and
    no pair dropped, weighted and summed into their token, then the shared
    experts once.  The pairs are sorted by held expert, the others last,
    and the experts' products are grouped GEMMs over device offsets
    (``torch._grouped_mm``), so that nothing is read back to the host."""
    b, s, d = x.shape
    t, k, e = b * s, cfg.experts_per_tok, cfg.n_experts
    xf = x.reshape(t, d)
    with spans.span("moe.route"):
        _, top_idx, weights = group_limited_route(p, cfg, xf)
        local = top_idx.reshape(-1) - cfg.expert_offset      # [T*k]
        held = (local >= 0) & (local < e)
        key = torch.where(held, local, e)
        order = torch.argsort(key, stable=True)
        # pairs a held expert has, counted on the device (``bincount``
        # reads the largest key back to the host)
        counts = torch.zeros(e + 1, dtype=torch.int64, device=key.device)
        counts.index_add_(0, key, torch.ones_like(key))
        offs = torch.cumsum(counts[:e], 0).to(torch.int32)
        held_sorted = held[order]
    with spans.span("moe.experts"):
        w = p["experts"]
        xs = xf.index_select(0, order // k)
        hid = F.silu(torch._grouped_mm(xs, w["w1"], offs=offs)) \
            * torch._grouped_mm(xs, w["w3"], offs=offs)
        ys = torch._grouped_mm(hid, w["w2"], offs=offs)
        # the rows past the held pairs are left unwritten by the products
        ys = torch.where(held_sorted[:, None],
                         ys * weights.reshape(-1)[order, None].to(ys.dtype),
                         0)
        y = torch.empty_like(ys).index_copy_(0, order, ys)
        y = y.view(t, k, d).sum(dim=1)
    if cfg.n_shared_experts:
        with spans.span("moe.shared"):
            y = y + mlp_apply(p["shared"], xf)
    return y.reshape(b, s, d)


def moe_apply(p: Params, cfg: ArchConfig, x: torch.Tensor,
              capacity_factor: float = 1.25) -> torch.Tensor:
    """Top-k token-choice MoE with capacity-bounded dispatch.  On DTensors
    with a model axis bound, the expert-parallel path
    (``_moe_routed_sharded``); otherwise the JAX package's single-device
    path (``moe_route``, a scatter-add into ``[E, cap, D]`` buffers, the
    experts' batched products, the gather and the prob-weighted sum).  The
    shared experts follow either.  A config that routes over a held share
    of the experts (``cfg.held_experts``) takes ``moe_held_apply``."""
    with spans.span("moe"):
        if cfg.held_experts:
            return moe_held_apply(p, cfg, x)
        return _moe_capacity_apply(p, cfg, x, capacity_factor)


def _moe_capacity_apply(p: Params, cfg: ArchConfig, x: torch.Tensor,
                        capacity_factor: float) -> torch.Tensor:
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
