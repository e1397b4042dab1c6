"""Plain reference of the LM blocks the benchmark's configurations run:
the dense block (RMSNorm, rotary attention over every head, SwiGLU MLP),
the Mamba2 block and the shared attention block and the LM head, in
float32 with TF32 off.

It follows the equations the configurations state (their ``assumed``
and ``departures`` say where those leave the published models):

* dense block: ``x + attn(rms(x) g1)``, then ``x + mlp(rms(x) g2)``;
  attention with RoPE (theta from the config) on all of dh, the halves
  of a head rotated as a pair, a causal softmax over q·k / sqrt(dh);
  the MLP ``(silu(x W1) * (x W3)) W2``;
* Mamba2 block: ``x + W_out(y)``, with ``xn = rms(x) g``, ``(u, z) =
  xn W_in``, ``(B, C) = xn W_bc`` (one group of ``ssm_state``), ``Δ =
  softplus(xn W_dt)`` per channel, ``u = silu(causal_conv(u))``, ``A =
  -exp(a_log)`` per channel, ``h_t = exp(Δ_t A) h_{t-1} + Δ_t u_t B_t``,
  ``y_t = h_t · C_t + u_t d_skip``, then ``y * silu(z)``;
* the shared block: one set of dense-block weights applied at each
  ``sattn`` entry of the pattern;
* the head ``rms(h) g_f`` times the untied ``unemb`` or ``embᵀ``.

Weights arrive in the parameter tree the benchmark made and are used as
fp32 whatever their type.  Long sequences attend in query blocks, so that
only a block's scores exist at a time.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from cardbench.reference.precision import Precision

Q_BLOCK = 1024


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * g.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """``x [B, S, H, dh]`` at positions 0..S-1; the angles in fp32, as the
    published models compute them."""
    s, dh = x.shape[1], x.shape[-1]
    exps = torch.arange(0, dh, 2, dtype=torch.float32, device=x.device) / dh
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * (1.0 / theta ** exps)
    cos = torch.cos(ang)[:, None, :]
    sin = torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p: dict, x: torch.Tensor, arch: dict,
              prec: Precision) -> torch.Tensor:
    b, s, _ = x.shape
    h, hkv = arch["n_heads"], arch["n_kv_heads"]
    dh = arch.get("d_head") or arch["d_model"] // h
    q = rope(prec.mm(x, p["wq"]).view(b, s, h, dh), arch["rope_theta"])
    k = rope(prec.mm(x, p["wk"]).view(b, s, hkv, dh), arch["rope_theta"])
    v = prec.mm(x, p["wv"]).view(b, s, hkv, dh)
    k = k.repeat_interleave(h // hkv, dim=2).transpose(1, 2)
    v = v.repeat_interleave(h // hkv, dim=2).transpose(1, 2)
    q = q.transpose(1, 2)
    outs = []
    for i in range(0, s, Q_BLOCK):
        qb = q[:, :, i:i + Q_BLOCK]
        scores = prec.bmm(qb, k.transpose(-1, -2)) / math.sqrt(dh)
        qpos = torch.arange(i, i + qb.shape[2], device=x.device)[:, None]
        kpos = torch.arange(s, device=x.device)[None, :]
        scores = scores.masked_fill(kpos > qpos, float("-inf"))
        outs.append(prec.bmm(torch.softmax(scores, dim=-1), v))
    out = torch.cat(outs, dim=2).transpose(1, 2).reshape(b, s, h * dh)
    return prec.mm(out, p["wo"])


def mlp(p: dict, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    return prec.mm(F.silu(prec.mm(x, p["w1"])) * prec.mm(x, p["w3"]),
                   p["w2"])


def dense_block(p: dict, x: torch.Tensor, arch: dict,
                prec: Precision) -> torch.Tensor:
    eps = arch["norm_eps"]
    x = x + attention(p["attn"], rmsnorm(x, p["ln1"], eps), arch, prec)
    return x + mlp(p["mlp"], rmsnorm(x, p["ln2"], eps), prec)


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def mamba_block(p: dict, x: torch.Tensor, arch: dict,
                prec: Precision) -> torch.Tensor:
    b, s, d = x.shape
    di, n = arch["ssm_expand"] * d, arch["ssm_state"]
    xn = rmsnorm(x, p["norm"], arch["norm_eps"])
    uz = prec.mm(xn, p["w_in"])
    u, z = uz[..., :di], uz[..., di:]
    bc = prec.mm(xn, p["w_bc"])
    bmat, cmat = bc[..., :n], bc[..., n:]
    dt = softplus(prec.mm(xn, p["w_dt"]))
    w = p["conv_w"].float()
    taps = w.shape[0]
    padded = F.pad(u, (0, 0, taps - 1, 0))
    u = F.silu(sum(padded[:, i:i + s] * w[i] for i in range(taps)))
    a = -torch.exp(p["a_log"].float())
    hstate = x.new_zeros((b, di, n))
    ys = []
    for t in range(s):
        hstate = (hstate * torch.exp(dt[:, t] * a)[..., None]
                  + (dt[:, t] * u[:, t])[..., None] * bmat[:, t, None, :])
        ys.append((hstate * cmat[:, t, None, :]).sum(-1))
    y = (torch.stack(ys, dim=1) + u * p["d_skip"].float()) * F.silu(z)
    return x + prec.mm(y, p["w_out"])


def block(kind: str, params: dict, i: int, x: torch.Tensor, arch: dict,
          prec: Precision) -> torch.Tensor:
    if kind == "attn":
        return dense_block(params["layers"][i], x, arch, prec)
    if kind == "sattn":
        return dense_block(params["shared_attn"], x, arch, prec)
    if kind == "mamba":
        return mamba_block(params["layers"][i], x, arch, prec)
    raise ValueError(f"the reference has no block {kind!r}")


def pattern(arch: dict) -> Sequence[str]:
    return arch.get("block_pattern") or ["attn"] * arch["n_layers"]


def hidden(params: dict, tokens: torch.Tensor, arch: dict,
           prec: Precision) -> torch.Tensor:
    """The last block's output for ``tokens [B, S]``."""
    x = params["emb"].float()[tokens]
    for i, kind in enumerate(pattern(arch)):
        x = block(kind, params, i, x, arch, prec)
    return x


def logits(params: dict, h: torch.Tensor, arch: dict,
           prec: Precision) -> torch.Tensor:
    h = rmsnorm(h, params["ln_f"], arch["norm_eps"])
    unemb = params["emb"].T if arch["tie_embeddings"] else params["unemb"]
    return prec.mm(h, unemb)


def position_logits(params: dict, tokens: torch.Tensor,
                    positions: Optional[torch.Tensor], arch: dict,
                    prec: Precision) -> torch.Tensor:
    """Logits ``[B, len(positions), V]`` of ``tokens [B, S]`` at the given
    positions (the next token's distribution after each)."""
    h = hidden(params, tokens, arch, prec)
    return logits(params, h[:, positions], arch, prec)
