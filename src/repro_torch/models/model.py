"""Model assembly for the dense decoder-only configs: init, forward,
prefill, decode.

The counterpart of the JAX package's ``repro/models/model.py`` for configs
whose every block is ``attn`` (tinyllama-1.1b, qwen3-4b, llama2-7b,
minicpm-2b, stablelm-1.6b).  Parameters are plain dicts of tensors:
``{"emb", "ln_f", ["unemb"], "layers": [per-layer dict]}``, and a Python
loop over ``layers`` takes the place of the JAX package's ``lax.scan``
over stacked segments.  :func:`params_from_numpy` carries the JAX
package's parameter tree across, so that both compute the same thing.

The KV cache is a list with one ``{"k", "v"}`` dict of tensors per layer,
updated in place by prefill and decode (JAX returns updated copies); the
caches these functions return are the tensors they were given.

Configs with MoE or MLA blocks, M-RoPE, SSM/xLSTM blocks, an encoder or a
shared attention block raise ``NotImplementedError``; ROADMAP.md Queue 1
names the slice that brings each.  ``lm_loss`` and the train step come
with the training slice.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig

Params = Dict[str, Any]

# the slice of ROADMAP.md Queue 1 that brings what the port cannot run yet
LM_FAMILIES_SLICE = "ROADMAP.md Queue 1, slice 6 (LM families)"


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` unless ``cfg`` is a dense
    decoder-only config, which is all the port runs so far."""
    missing = [what for what, present in (
        ("MoE blocks", cfg.moe or "moe" in cfg.pattern),
        ("MLA attention", cfg.mla),
        ("M-RoPE", cfg.mrope),
        ("SSM/xLSTM blocks",
         any(b in ("mamba", "mlstm", "slstm") for b in cfg.pattern)),
        ("an encoder (enc_layers)", cfg.enc_layers > 0),
        ("a shared attention block (shared_attn_every)",
         cfg.shared_attn_every > 0)) if present]
    others = sorted(set(cfg.pattern) - {"attn", "moe", "mamba", "mlstm",
                                        "slstm"})
    if others:
        missing.append(f"block kinds {others}")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet; they come "
            f"with {LM_FAMILIES_SLICE}")


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

def _block_init(gen: torch.Generator, cfg: ArchConfig,
                dtype: torch.dtype) -> Params:
    return {"ln1": L.rmsnorm_init(cfg.d_model, dtype, gen.device),
            "attn": L.gqa_init(gen, cfg, dtype),
            "ln2": L.rmsnorm_init(cfg.d_model, dtype, gen.device),
            "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype)}


def init_params(cfg: ArchConfig, gen: torch.Generator) -> Params:
    """Random parameters drawn from ``gen``, on ``gen``'s device, in
    ``cfg.dtype``.  The draws are not the JAX package's (``jax.random``
    and torch generators differ); carry those across with
    :func:`params_from_numpy`."""
    check_supported(cfg)
    dtype = torch_dtype(cfg)
    p: Params = {
        "emb": L.dense_init(gen, cfg.vocab, cfg.d_model, dtype, scale=0.02),
        "ln_f": L.rmsnorm_init(cfg.d_model, dtype, gen.device),
    }
    if not cfg.tie_embeddings:
        p["unemb"] = L.dense_init(gen, cfg.d_model, cfg.vocab, dtype)
    p["layers"] = [_block_init(gen, cfg, dtype)
                   for _ in range(cfg.n_layers)]
    return p


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(cfg: ArchConfig, tree: Params,
                      device: torch.device | str,
                      dtype: Optional[torch.dtype] = None) -> Params:
    """The port's parameters from the JAX package's parameter tree with
    numpy leaves (``{"emb", "ln_f", ["unemb"], "segments": [dict of arrays
    with a leading layer axis]}``), on ``device`` in ``dtype`` (default
    ``cfg.dtype``).  Leaves go through fp32, which holds a bf16 value
    exactly (``torch.from_numpy`` refuses numpy's bfloat16)."""
    check_supported(cfg)
    dtype = dtype or torch_dtype(cfg)

    def leaf(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=device, dtype=dtype)

    p: Params = {"emb": leaf(tree["emb"]), "ln_f": leaf(tree["ln_f"])}
    if not cfg.tie_embeddings:
        p["unemb"] = leaf(tree["unemb"])
    p["layers"] = [_map(lambda a, i=i: leaf(np.asarray(a)[i]), seg)
                   for (_, count), seg in zip(segments_of(cfg),
                                              tree["segments"])
                   for i in range(count)]
    return p


# -- per-block apply ----------------------------------------------------------

def block_apply(kind: str, cfg: ArchConfig, p: Params, x: torch.Tensor,
                positions: torch.Tensor, cache: Optional[Dict] = None):
    """Returns (x, new_cache)."""
    if kind != "attn":
        raise NotImplementedError(f"block kind {kind!r} not ported yet; it "
                                  f"comes with {LM_FAMILIES_SLICE}")
    h, new_cache = L.gqa_attention(p["attn"], cfg,
                                   L.rmsnorm(x, p["ln1"], cfg.norm_eps),
                                   positions, cache)
    x = x + h
    x = x + L.mlp_apply(p["mlp"], L.rmsnorm(x, p["ln2"], cfg.norm_eps))
    return x, new_cache


# -- caches -------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               device: torch.device | str) -> List[Dict[str, torch.Tensor]]:
    """One zeroed ``{"k", "v" [batch, max_seq, n_kv_heads, head_dim]}`` per
    layer, in ``cfg.dtype``."""
    check_supported(cfg)
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=torch_dtype(cfg), device=device),
             "v": torch.zeros(shape, dtype=torch_dtype(cfg), device=device)}
            for _ in range(cfg.n_layers)]


# -- forward ------------------------------------------------------------------

def forward(cfg: ArchConfig, params: Params, x: torch.Tensor,
            positions: torch.Tensor, caches: Optional[List] = None,
            index: Optional[int] = None):
    """Backbone forward. ``x`` [B,S,D] embeddings; with ``caches``, the new
    keys and values go in at position ``index``.  Returns (h, caches)."""
    check_supported(cfg)
    for i, (kind, p_l) in enumerate(zip(cfg.pattern, params["layers"])):
        cache = None if caches is None else dict(caches[i], index=index)
        x, _ = block_apply(kind, cfg, p_l, x, positions, cache)
    return x, caches


def embed(cfg: ArchConfig, params: Params, tokens: torch.Tensor
          ) -> torch.Tensor:
    return params["emb"][tokens]


def logits_of(cfg: ArchConfig, params: Params, h: torch.Tensor
              ) -> torch.Tensor:
    """Final norm and projection onto the vocabulary."""
    h = L.rmsnorm(h, params["ln_f"], cfg.norm_eps)
    unemb = params["emb"].T if cfg.tie_embeddings else params["unemb"]
    return h @ unemb


# -- task-level functions -----------------------------------------------------

def prefill(cfg: ArchConfig, params: Params, tokens: torch.Tensor, caches):
    """Run the prompt ``tokens`` [B, S] through the model, filling caches
    from position 0; returns (last-token logits [B, 1, V], caches)."""
    x = embed(cfg, params, tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    h, caches = forward(cfg, params, x, positions, caches=caches, index=0)
    return logits_of(cfg, params, h[:, -1:]), caches


def decode_step(cfg: ArchConfig, params: Params, token: torch.Tensor,
                index: int, caches):
    """One decode step: ``token`` [B] at position ``index``; returns
    (logits [B, V], caches)."""
    x = embed(cfg, params, token[:, None])
    b = x.shape[0]
    positions = torch.full((b, 1), index, dtype=torch.int64,
                           device=x.device)
    h, caches = forward(cfg, params, x, positions, caches=caches,
                        index=index)
    return logits_of(cfg, params, h)[:, 0], caches
