"""Model assembly: any ArchConfig -> init, forward, loss, prefill, decode.

The counterpart of the JAX package's ``repro/models/model.py`` for every
config: dense and MoE transformers (GQA or MLA attention), qwen2-vl's
M-RoPE backbone with prepended patch embeddings, zamba2's Mamba2 blocks
with a shared attention block, xLSTM stacks, and seamless's
encoder-decoder.  Parameters are plain dicts of tensors: ``{"emb",
"ln_f", ["unemb"], "layers": [one dict per entry of cfg.pattern],
["shared_attn"], ["encoder": [one dict per encoder layer]]}``; a ``sattn``
entry of ``layers`` is an empty dict, since the shared block's parameters
are stored once, in ``shared_attn``.  A Python loop over the pattern takes
the place of the JAX package's ``lax.scan`` over stacked segments, and
:func:`params_from_numpy` carries the JAX package's parameter tree
across, so that both compute the same thing.  ``torch.utils.checkpoint``
wraps each block of the cache-free forward when ``cfg.remat``, where the
JAX package wraps its scanned blocks in ``jax.checkpoint`` (the shared
block in neither).

Whole-sequence attention is chosen by the ``flash`` argument, passed down
to every attention (self, shared, cross and encoder): the flash-attention
kernel for serving, the JAX package's chunked einsum path for
:func:`lm_loss`, which autograd differentiates (the kernel, like the JAX
package's, has no backward).  MLA keeps its own einsum product either way.

On DTensors (the dry-run of :mod:`repro_torch.launch.dryrun`) the
embedding lookup, the logits and the loss follow the sharding hints of
:mod:`repro_torch.models.layers`: the lookup and the vocab padding run on
each rank's shards, the logits shard the vocab over the model axis, and
the gold logit is a masked sum over it.

The caches are a list with one dict per entry of ``cfg.pattern``: ``{"k",
"v"}`` (GQA, each ``sattn`` its own), ``{"latent", "k_rope"}`` (MLA), or
the recurrent state of a Mamba2/xLSTM block.  Prefill and decode write
keys and values into the given tensors in place (JAX returns updated
copies) and put each block's new recurrent state into the list.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.config import ArchConfig

Params = Dict[str, Any]

# leaves kept in fp32 whatever the working type, as the JAX package's init
# makes them
FP32_LEAVES = ("a_log",)


def torch_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# -- pattern segmentation -----------------------------------------------------

def segments_of(cfg: ArchConfig) -> List[Tuple[str, int]]:
    """Runs of equal block kinds, as the JAX package stacks its parameters
    (one segment of ``n_layers`` ``attn`` blocks for a dense config)."""
    segs: List[Tuple[str, int]] = []
    for kind in cfg.pattern:
        if segs and segs[-1][0] == kind:
            segs[-1] = (kind, segs[-1][1] + 1)
        else:
            segs.append((kind, 1))
    return segs


# -- init ---------------------------------------------------------------------

def _attn_init(gen: torch.Generator, cfg: ArchConfig,
               dtype: torch.dtype) -> Params:
    if cfg.mla:
        return L.mla_init(gen, cfg, dtype)
    return L.gqa_init(gen, cfg, dtype)


def _block_init(kind: str, gen: torch.Generator, cfg: ArchConfig,
                dtype: torch.dtype) -> Params:
    d = cfg.d_model
    if kind in ("attn", "moe"):
        p = {"ln1": L.rmsnorm_init(d, dtype, gen.device),
             "attn": _attn_init(gen, cfg, dtype),
             "ln2": L.rmsnorm_init(d, dtype, gen.device)}
        if kind == "moe":
            p["moe"] = L.moe_init(gen, cfg, dtype)
        else:
            p["mlp"] = L.mlp_init(gen, d, cfg.d_ff, dtype)
        return p
    if kind == "xdec":   # encoder-decoder decoder block (self + cross + mlp)
        return {"ln1": L.rmsnorm_init(d, dtype, gen.device),
                "attn": L.gqa_init(gen, cfg, dtype),
                "lnx": L.rmsnorm_init(d, dtype, gen.device),
                "xattn": L.gqa_init(gen, cfg, dtype),
                "ln2": L.rmsnorm_init(d, dtype, gen.device),
                "mlp": L.mlp_init(gen, d, cfg.d_ff, dtype)}
    if kind == "sattn":  # shared block: parameters in params["shared_attn"]
        return {}
    if kind == "mamba":
        return S.mamba_init(gen, cfg, dtype)
    if kind == "mlstm":
        return S.mlstm_init(gen, cfg, dtype)
    if kind == "slstm":
        return S.slstm_init(gen, cfg, dtype)
    raise ValueError(kind)


def init_params(cfg: ArchConfig, gen: torch.Generator) -> Params:
    """Random parameters drawn from ``gen``, on ``gen``'s device, in
    ``cfg.dtype``.  The draws are not the JAX package's (``jax.random``
    and torch generators differ); carry those across with
    :func:`params_from_numpy`."""
    dtype = torch_dtype(cfg)
    p: Params = {
        "emb": L.dense_init(gen, cfg.vocab, cfg.d_model, dtype, scale=0.02),
        "ln_f": L.rmsnorm_init(cfg.d_model, dtype, gen.device),
    }
    if not cfg.tie_embeddings:
        p["unemb"] = L.dense_init(gen, cfg.d_model, cfg.vocab, dtype)
    p["layers"] = [_block_init(kind, gen, cfg, dtype) for kind in cfg.pattern]
    if cfg.shared_attn_every:
        p["shared_attn"] = _block_init("attn", gen, cfg, dtype)
    if cfg.enc_layers:
        p["encoder"] = [_block_init("attn", gen, cfg, dtype)
                        for _ in range(cfg.enc_layers)]
    return p


def _map(fn, tree, key: str = ""):
    """``fn(leaf, key)`` over a dict tree; ``key`` is the leaf's own name."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, k) for k, v in tree.items()}
    return fn(tree, key)


def params_from_numpy(cfg: ArchConfig, tree: Params,
                      device: torch.device | str,
                      dtype: Optional[torch.dtype] = None) -> Params:
    """The port's parameters from the JAX package's parameter tree with
    numpy leaves (``{"emb", "ln_f", ["unemb"], "segments": [a dict of
    arrays with a leading layer axis per segment, None for a sattn
    segment], ["shared_attn"], ["encoder": a dict with a leading layer
    axis]}``, experts stacked ``[count, E, ...]``), on ``device`` in
    ``dtype`` (default ``cfg.dtype``; ``FP32_LEAVES`` stay fp32 unless a
    dtype is given).  Leaves go through fp32, which holds a bf16 value
    exactly (``torch.from_numpy`` refuses numpy's bfloat16)."""
    explicit = dtype is not None
    dtype = dtype or torch_dtype(cfg)

    def leaf(a, key: str = "") -> torch.Tensor:
        want = dtype if explicit or key not in FP32_LEAVES else torch.float32
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=device, dtype=want)

    def layer(seg, i: int) -> Params:
        return _map(lambda a, key: leaf(np.asarray(a)[i], key), seg)

    p: Params = {"emb": leaf(tree["emb"]), "ln_f": leaf(tree["ln_f"])}
    if not cfg.tie_embeddings:
        p["unemb"] = leaf(tree["unemb"])
    p["layers"] = [{} if kind == "sattn" else layer(seg, i)
                   for (kind, count), seg in zip(segments_of(cfg),
                                                 tree["segments"])
                   for i in range(count)]
    if cfg.shared_attn_every:
        p["shared_attn"] = _map(leaf, tree["shared_attn"])
    if cfg.enc_layers:
        p["encoder"] = [layer(tree["encoder"], i)
                        for i in range(cfg.enc_layers)]
    return p


# -- per-block apply ----------------------------------------------------------

def _attention(p: Params, cfg: ArchConfig, x: torch.Tensor,
               positions: torch.Tensor, cache, pos3, flash: bool):
    if cfg.mla:
        return L.mla_attention(p, cfg, x, positions, cache)
    return L.gqa_attention(p, cfg, x, positions, cache, pos3=pos3,
                           flash=flash)


def block_apply(kind: str, cfg: ArchConfig, p: Params, x: torch.Tensor,
                positions: torch.Tensor, cache: Optional[Dict] = None,
                pos3: Optional[torch.Tensor] = None,
                enc_out: Optional[torch.Tensor] = None, flash: bool = True):
    """Returns (x, new_cache).  ``flash``: whole-sequence attention through
    the flash-attention kernel, else the einsum path."""
    if kind in ("attn", "moe", "xdec"):
        h, new_cache = _attention(p["attn"], cfg,
                                  L.rmsnorm(x, p["ln1"], cfg.norm_eps),
                                  positions, cache, pos3, flash)
        x = x + h
        if kind == "xdec" and enc_out is not None:
            h, _ = L.gqa_attention(p["xattn"], cfg,
                                   L.rmsnorm(x, p["lnx"], cfg.norm_eps),
                                   positions, None, kv_source=enc_out,
                                   flash=flash)
            x = x + h
        xin = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
        if kind == "moe":
            x = x + L.moe_apply(p["moe"], cfg, xin)
        else:
            x = x + L.mlp_apply(p["mlp"], xin)
        return x, new_cache
    if kind == "mamba":
        return S.mamba_apply(p, cfg, x, cache)
    if kind == "mlstm":
        return S.mlstm_apply(p, cfg, x, cache)
    if kind == "slstm":
        return S.slstm_apply(p, cfg, x, cache)
    raise ValueError(kind)


# -- caches / states ----------------------------------------------------------

def _block_cache(kind: str, cfg: ArchConfig, batch: int, max_seq: int,
                 device: torch.device | str) -> Dict[str, torch.Tensor]:
    dtype = torch_dtype(cfg)
    if kind in ("attn", "moe", "xdec", "sattn"):
        if cfg.mla:
            return {"latent": torch.zeros((batch, max_seq, cfg.kv_lora_rank),
                                          dtype=dtype, device=device),
                    "k_rope": torch.zeros((batch, max_seq,
                                           cfg.rope_head_dim),
                                          dtype=dtype, device=device)}
        shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    if kind == "mamba":
        return S.mamba_state(cfg, batch, device, dtype)
    if kind == "mlstm":
        return S.mlstm_state(cfg, batch, device)
    if kind == "slstm":
        return S.slstm_state(cfg, batch, device)
    raise ValueError(kind)


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               device: torch.device | str) -> List[Dict[str, torch.Tensor]]:
    """One zeroed cache or state per entry of ``cfg.pattern``, in
    ``cfg.dtype`` (the recurrent states' fp32 parts in fp32)."""
    return [_block_cache(kind, cfg, batch, max_seq, device)
            for kind in cfg.pattern]


# -- forward ------------------------------------------------------------------

def _with_index(cache: Dict, idx: Optional[int]) -> Dict:
    if "k" in cache or "latent" in cache:
        return dict(cache, index=idx)
    return cache


def _block_out(kind: str, cfg: ArchConfig, p_l: Params, x: torch.Tensor,
               positions: torch.Tensor, pos3, enc_out,
               flash: bool) -> torch.Tensor:
    return block_apply(kind, cfg, p_l, x, positions, None, pos3, enc_out,
                       flash)[0]


def forward(cfg: ArchConfig, params: Params, x: torch.Tensor,
            positions: torch.Tensor, caches: Optional[List] = None,
            index: Optional[int] = None, pos3: Optional[torch.Tensor] = None,
            enc_out: Optional[torch.Tensor] = None, flash: bool = True):
    """Backbone forward. ``x`` [B,S,D] embeddings; with ``caches``, the new
    keys and values go in at position ``index`` and each block's new state
    replaces its entry of the list.  Returns (h, caches).

    ``flash``: whole-sequence attention through the flash-attention kernel
    (forward only), else the JAX package's einsum path.  Without caches
    and with ``cfg.remat``, each block's activations but the shared
    block's are recomputed in the backward pass
    (``torch.utils.checkpoint``)."""
    for i, kind in enumerate(cfg.pattern):
        if kind == "sattn":
            body, p_l = "attn", params["shared_attn"]
        else:
            body, p_l = kind, params["layers"][i]
        if caches is not None:
            x, nc = block_apply(body, cfg, p_l, x, positions,
                                _with_index(caches[i], index), pos3,
                                enc_out, flash)
            caches[i] = {k: v for k, v in nc.items() if k != "index"}
        elif cfg.remat and kind != "sattn":
            x = checkpoint(_block_out, body, cfg, p_l, x, positions, pos3,
                           enc_out, flash, use_reentrant=False)
        else:
            x = _block_out(body, cfg, p_l, x, positions, pos3, enc_out,
                           flash)
    return x, caches


def encode(cfg: ArchConfig, params: Params, feats: torch.Tensor,
           positions: torch.Tensor, flash: bool = True) -> torch.Tensor:
    """Bidirectional encoder over (stubbed) frontend features [B,S,D]."""
    x = feats
    for p_l in params["encoder"]:
        h, _ = L.gqa_attention(p_l["attn"], cfg,
                               L.rmsnorm(x, p_l["ln1"], cfg.norm_eps),
                               positions, None, causal=False, flash=flash)
        x = x + h
        x = x + L.mlp_apply(p_l["mlp"],
                            L.rmsnorm(x, p_l["ln2"], cfg.norm_eps))
    return x


def embed(cfg: ArchConfig, params: Params, tokens: torch.Tensor
          ) -> torch.Tensor:
    """The rows of ``tokens``.  On DTensors, a lookup on each rank's
    tokens (over the data axes) in its share of the features (over the
    model axis), the layout ``L.shard_tokens`` asks of the result."""
    emb = params["emb"]
    rows = (L.data_axes() or None,) + (None,) * (tokens.ndim - 1)
    return L.on_shards(lambda e, t: e[t], (emb, tokens),
                       ((None, L.model_axis()), rows),
                       rows + (L.model_axis(),),
                       tuple(tokens.shape) + (emb.shape[1],))


def logits_of(cfg: ArchConfig, params: Params, h: torch.Tensor,
              pad_vocab: bool = False) -> torch.Tensor:
    """Final norm and projection onto the vocabulary.  ``pad_vocab``: the
    output dim padded to a multiple of 512 (minicpm's 122753 cannot shard
    over a 16-way model axis), the padded columns -1e30, so that a
    logsumexp over them is unchanged."""
    h = L.rmsnorm(h, params["ln_f"], cfg.norm_eps)
    unemb = params["emb"].T if cfg.tie_embeddings else params["unemb"]
    pad = (-cfg.vocab) % 512 if pad_vocab else 0
    if pad:
        # on each rank's rows of the feature dim (the vocab dim whole there)
        rows = (L.data_axes() + (L.model_axis(),), None)
        unemb = L.on_shards(lambda u: F.pad(u, (0, pad)), (unemb,), (rows,),
                            rows)
    if L.model_axis():
        # the vocab over the model axis, the tokens over the data axes: the
        # weight is gathered along its feature dim (FSDP) rather than the
        # tokens along theirs
        h = L._maybe_shard(h, (L.data_axes() or None,)
                           + (None,) * (h.ndim - 1))
        unemb = L._maybe_shard(unemb, (None, L.model_axis()))
    logits = h @ unemb
    if pad:
        padded = torch.arange(cfg.vocab + pad, device=h.device) >= cfg.vocab
        logits = torch.where(padded, -1e30, logits)
    return logits


# -- task-level functions -----------------------------------------------------

def _inputs(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
            extra_embeds, enc_feats, flash: bool):
    """Embeddings (``extra_embeds`` prepended), their positions, and the
    encoder's output when the config has an encoder and ``enc_feats`` is
    given."""
    x = embed(cfg, params, tokens)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    x = L.shard_tokens(x)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    enc_out = None
    if cfg.enc_layers and enc_feats is not None:
        enc_pos = torch.arange(enc_feats.shape[1], device=x.device).expand(
            enc_feats.shape[:2])
        enc_out = encode(cfg, params, enc_feats.to(x.dtype), enc_pos, flash)
    return x, positions, enc_out


def lm_loss(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
            labels: torch.Tensor, extra_embeds=None, pos3=None,
            enc_feats=None) -> torch.Tensor:
    """Causal-LM cross entropy (fp32 scalar) of ``tokens`` against
    ``labels`` [B, S], attending through the einsum path, so that autograd
    differentiates it.  ``extra_embeds`` (VLM patch stubs) are prepended
    and their logits dropped; ``enc_feats`` (audio stubs) drive the
    encoder of enc-dec architectures."""
    x, positions, enc_out = _inputs(cfg, params, tokens, extra_embeds,
                                    enc_feats, flash=False)
    h, _ = forward(cfg, params, x, positions, pos3=pos3, enc_out=enc_out,
                   flash=False)
    logits = logits_of(cfg, params, h, pad_vocab=bool(L.model_axis()))
    if extra_embeds is not None:
        logits = logits[:, extra_embeds.shape[1]:]
    # logits shard vocab over the model axis: the [B,S,V] fp32 tensor is
    # by far the largest activation
    logits = L.shard_tokens(logits.float())
    logz = torch.logsumexp(logits, dim=-1)
    if isinstance(logits, DTensor):
        # the gold logit as a masked sum over the vocab, which stays
        # sharded over the model axis (the gather's backward would scatter
        # into replicated [B,S,V] zeros)
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        gold = L.shard_tokens(torch.where(vocab == labels.long()[..., None],
                                          logits, 0.0).sum(-1))
        logz = L.shard_tokens(logz)
    else:
        gold = torch.take_along_dim(logits, labels.long()[..., None],
                                    dim=-1)[..., 0]
    return torch.mean(logz - gold)


def prefill(cfg: ArchConfig, params: Params, tokens: torch.Tensor, caches,
            extra_embeds=None, pos3=None, enc_feats=None, flash: bool = True):
    """Run the prompt ``tokens`` [B, S] (after ``extra_embeds``) through the
    model, filling caches from position 0; returns (last-token logits
    [B, 1, V], caches).  The encoder's output is not returned (as in the
    JAX package): a decode step that cross-attends takes ``encode(...)``.
    ``flash=False`` attends through the einsum path instead of the
    kernel."""
    x, positions, enc_out = _inputs(cfg, params, tokens, extra_embeds,
                                    enc_feats, flash)
    h, caches = forward(cfg, params, x, positions, caches=caches, index=0,
                        pos3=pos3, enc_out=enc_out, flash=flash)
    return logits_of(cfg, params, h[:, -1:]), caches


def decode_step(cfg: ArchConfig, params: Params, token: torch.Tensor,
                index: int, caches, enc_out: Optional[torch.Tensor] = None):
    """One decode step: ``token`` [B] at position ``index``; returns
    (logits [B, V], caches).  An M-RoPE config rotates by ``index`` in all
    three position streams."""
    x = embed(cfg, params, token[:, None])
    b = x.shape[0]
    positions = torch.full((b, 1), index, dtype=torch.int64,
                           device=x.device)
    pos3 = positions.expand(3, b, 1) if cfg.mrope else None
    h, caches = forward(cfg, params, x, positions, caches=caches,
                        index=index, pos3=pos3, enc_out=enc_out)
    return logits_of(cfg, params, h)[:, 0], caches
