"""Plain reference of DeepSeek-V2's blocks at one device's share of an
expert-parallel layer: multi-head latent attention (MLA) with YaRN, the
dense SwiGLU MLP of the leading layers, and DeepSeekMoE with
group-limited routing over every routed expert, of which only the held
ones are computed, plus the shared experts; in float32 with TF32 off.

It follows the published equations (arXiv:2405.04434 §2; the
configuration's ``departures`` say where the cell leaves them):

* MLA: ``c_q = rms(x W_dq) g_q``, ``[q_nope | q_pe] = c_q W_uq`` per
  head; ``[c_kv | k_pe] = x W_dkv``, ``c_kv = rms(c_kv) g_kv``; ``k_nope
  = c_kv W_uk`` and ``v = c_kv W_uv`` per head (up-projected, not
  absorbed); ``q_pe`` and the one ``k_pe`` every head shares rotated by
  YaRN's frequencies, the halves of the rotary part as a pair; scores
  ``(q_nope·k_nope + q_pe·k_pe)`` times ``(dh + rd)^-1/2`` and YaRN's
  attention factor squared, a causal softmax, ``p v``, then ``W_o``;
* the block: ``x + attn(rms(x) g1)``, then ``x + ffn(rms(x) g2)``, the
  FFN the dense MLP ``(silu(x W1) * (x W3)) W2`` in the first
  ``first_dense`` layers and the MoE in the rest;
* the MoE: ``s = softmax(x W_router)`` over all ``router_experts``; each
  of ``n_group`` groups scored by its largest ``s``, the ``topk_group``
  best kept and the rest zeroed; the ``experts_per_tok`` largest scores
  left choose the experts, each weighted by its score times
  ``routed_scaling`` (no renormalisation); the held experts
  ``[expert_offset, expert_offset + n_experts)`` each computed for the
  tokens that chose it, weighted and summed, the others adding nothing;
  then the shared experts, one MLP of their summed width;
* the head ``rms(h) g_f`` times the untied ``unemb``.

Weights arrive in the parameter tree the benchmark made and are used as
fp32 whatever their type.  Attention runs in query blocks, so that only a
block's scores exist at a time.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from cardbench.reference.precision import Precision

Q_BLOCK = 256


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * g.float()


def _mscale(factor: float, m: float) -> float:
    return 0.1 * m * math.log(factor) + 1.0 if factor > 1 else 1.0


def rope_frequencies(arch: dict) -> torch.Tensor:
    """The rotary part's frequencies in float64: RoPE's, or with a YaRN
    factor ``s`` ``f m + f / s (1 - m)``, ``m`` 1 less the linear ramp
    from ``floor(c(beta_fast))`` to ``ceil(c(beta_slow))`` over the
    frequency index clamped to [0, 1], ``c(n) = d ln(L / (2 pi n)) / (2
    ln theta)``."""
    d, theta = arch["rope_head_dim"], arch["rope_theta"]
    f = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64) / d)
    s = arch.get("yarn_factor", 0.0)
    if not s:
        return f
    big_l = arch["yarn_original_max"]

    def c(n):
        return d * math.log(big_l / (2 * math.pi * n)) / (2 * math.log(theta))

    lo = max(math.floor(c(arch["yarn_beta_fast"])), 0)
    hi = min(math.ceil(c(arch["yarn_beta_slow"])), d - 1)
    if lo == hi:
        hi += 0.001
    ramp = ((torch.arange(d // 2, dtype=torch.float64) - lo)
            / (hi - lo)).clamp(0, 1)
    m = 1.0 - ramp
    return f * m + f / s * (1.0 - m)


def softmax_scale(arch: dict) -> float:
    scale = (arch["d_head"] + arch["rope_head_dim"]) ** -0.5
    s, m_all = arch.get("yarn_factor", 0.0), arch.get("yarn_mscale_all_dim",
                                                       0.0)
    if s and m_all:
        scale *= _mscale(s, m_all) ** 2
    return scale


def rope(x: torch.Tensor, arch: dict) -> torch.Tensor:
    """``x [B, S, H, d]`` at positions 0..S-1."""
    s = x.shape[1]
    freqs = rope_frequencies(arch).float().to(x.device)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    factor = arch.get("yarn_factor", 0.0)
    att = (_mscale(factor, arch.get("yarn_mscale", 1.0))
           / _mscale(factor, arch.get("yarn_mscale_all_dim", 0.0))
           if factor else 1.0)
    cos = (torch.cos(ang) * att)[:, None, :]
    sin = (torch.sin(ang) * att)[:, None, :]
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def mla(p: dict, x: torch.Tensor, arch: dict,
        prec: Precision) -> torch.Tensor:
    b, s, _ = x.shape
    h, dh, rd = arch["n_heads"], arch["d_head"], arch["rope_head_dim"]
    r, eps = arch["kv_lora_rank"], arch["norm_eps"]
    cq = rmsnorm(prec.mm(x, p["w_dq"]), p["q_norm"], eps)
    q = prec.mm(cq, p["w_uq"]).view(b, s, h, dh + rd)
    q_nope, q_pe = q[..., :dh], rope(q[..., dh:], arch)
    kv = prec.mm(x, p["w_dkv"])
    ckv = rmsnorm(kv[..., :r], p["kv_norm"], eps)
    k_pe = rope(kv[..., r:][:, :, None, :], arch)[:, :, 0]     # [B, S, rd]
    k_nope = prec.mm(ckv, p["w_uk"]).view(b, s, h, dh).transpose(1, 2)
    v = prec.mm(ckv, p["w_uv"]).view(b, s, h, dh).transpose(1, 2)
    q_nope, q_pe = q_nope.transpose(1, 2), q_pe.transpose(1, 2)
    scale = softmax_scale(arch)
    kpos = torch.arange(s, device=x.device)[None, :]
    outs = []
    for i in range(0, s, Q_BLOCK):
        qn, qp = q_nope[:, :, i:i + Q_BLOCK], q_pe[:, :, i:i + Q_BLOCK]
        scores = (prec.bmm(qn, k_nope.transpose(-1, -2))
                  + prec.bmm(qp, k_pe[:, None].transpose(-1, -2))) * scale
        qpos = torch.arange(i, i + qn.shape[2], device=x.device)[:, None]
        scores = scores.masked_fill(kpos > qpos, float("-inf"))
        outs.append(prec.bmm(torch.softmax(scores, dim=-1), v))
    out = torch.cat(outs, dim=2).transpose(1, 2).reshape(b, s, h * dh)
    return prec.mm(out, p["wo"])


def mlp(p: dict, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    return prec.mm(F.silu(prec.mm(x, p["w1"])) * prec.mm(x, p["w3"]),
                   p["w2"])


def route(router: torch.Tensor, x: torch.Tensor, arch: dict,
          prec: Precision):
    """Group-limited greedy routing of ``x [T, D]``: the chosen experts
    ``[T, k]`` and their weights ``[T, k]``."""
    scores = torch.softmax(prec.mm(x, router), dim=-1)
    t, e = scores.shape
    g = arch["n_group"]
    groups = scores.view(t, g, e // g)
    best = groups.amax(-1)
    keep = torch.sort(best, dim=-1, descending=True,
                      stable=True).indices[:, :arch["topk_group"]]
    mask = torch.zeros_like(best, dtype=torch.bool).scatter_(1, keep, True)
    masked = torch.where(mask[..., None], groups, 0.0).view(t, e)
    vals, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    k = arch["experts_per_tok"]
    return idx[:, :k], vals[:, :k] * arch["routed_scaling"]


def moe(p: dict, x: torch.Tensor, arch: dict,
        prec: Precision) -> torch.Tensor:
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    idx, weight = route(p["router"], xf, arch, prec)
    y = torch.zeros_like(xf)
    first = arch.get("expert_offset", 0)
    w = p["experts"]
    for j in range(arch["n_experts"]):
        tok, slot = torch.nonzero(idx == first + j, as_tuple=True)
        if tok.numel():
            expert = {"w1": w["w1"][j], "w3": w["w3"][j], "w2": w["w2"][j]}
            y.index_add_(0, tok, mlp(expert, xf[tok], prec)
                         * weight[tok, slot, None])
    y = y + mlp(p["shared"], xf, prec)
    return y.view(b, s, d)


def block(p: dict, x: torch.Tensor, arch: dict,
          prec: Precision) -> torch.Tensor:
    eps = arch["norm_eps"]
    x = x + mla(p["attn"], rmsnorm(x, p["ln1"], eps), arch, prec)
    xn = rmsnorm(x, p["ln2"], eps)
    return x + (moe(p["moe"], xn, arch, prec) if "moe" in p
                else mlp(p["mlp"], xn, prec))


def hidden(params: dict, tokens: torch.Tensor, arch: dict,
           prec: Precision) -> torch.Tensor:
    x = params["emb"].float()[tokens]
    for p in params["layers"]:
        x = block(p, x, arch, prec)
    return x


def position_logits(params: dict, tokens: torch.Tensor,
                    positions: Optional[torch.Tensor], arch: dict,
                    prec: Precision) -> torch.Tensor:
    """Logits ``[B, len(positions), V]`` of ``tokens [B, S]`` at the given
    positions (the next token's distribution after each)."""
    h = hidden(params, tokens, arch, prec)
    h = rmsnorm(h[:, positions], params["ln_f"], arch["norm_eps"])
    return prec.mm(h, params["unemb"])
