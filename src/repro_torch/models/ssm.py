"""Sub-quadratic sequence blocks: Mamba2 (zamba2) and xLSTM (sLSTM/mLSTM).

The counterpart of the JAX package's ``repro/models/ssm.py``.  These
blocks carry O(1)-per-token recurrent state: one decode step updates the
state instead of attending over a cache.  Mamba2's selective state-space
recurrence with input-dependent (Δ, B, C) and a short causal conv; xLSTM's
exponentially-gated scalar (sLSTM) and matrix (mLSTM) memories per head.

Each time scan (the reference's ``jax.lax.scan``) is a Python loop over
the sequence in fp32, with the reference's order of operations; a step is
a handful of small launches on the card.  ``softplus`` is
``logaddexp(x, 0)``, as ``jax.nn.softplus`` (``torch.nn.functional
.softplus`` switches to ``x`` above a threshold).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (Params, _maybe_shard, data_axes,
                                       dense_init, merge_heads, rmsnorm,
                                       rmsnorm_init, shard_tokens,
                                       split_heads)


# Time steps a scan computes; None: all of them.  The dry-run counts a
# shortened scan and scales it (every step has the same shapes, so its
# cost is linear in the steps; repro_torch.launch.costing): the steps past
# the limit repeat the last output, so that every later op sees the
# sequence's shapes.
_SCAN_STEPS: Dict[str, Optional[int]] = {"limit": None}


@contextlib.contextmanager
def scan_steps(limit: Optional[int]) -> Iterator[None]:
    """Each time scan computes at most ``limit`` steps in the body."""
    saved = _SCAN_STEPS["limit"]
    _SCAN_STEPS["limit"] = limit
    try:
        yield
    finally:
        _SCAN_STEPS["limit"] = saved


def _steps(s: int) -> int:
    limit = _SCAN_STEPS["limit"]
    return s if limit is None else min(s, limit)


def _stack_steps(ys: list, s: int) -> torch.Tensor:
    """The per-step outputs stacked on dim 1, the steps a shortened scan
    skipped repeating its last output."""
    return torch.stack(ys + [ys[-1]] * (s - len(ys)), dim=1)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


# -- Mamba2 -------------------------------------------------------------------

def mamba_init(gen: torch.Generator, cfg: ArchConfig,
               dtype: torch.dtype) -> Params:
    """``a_log`` stays fp32 whatever the working type, as in the JAX
    package."""
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n = cfg.ssm_state
    conv = torch.randn((cfg.conv_kernel, di), generator=gen,
                       dtype=torch.float32, device=gen.device)
    return {
        "w_in": dense_init(gen, d, 2 * di, dtype),          # -> (u, z)
        "w_bc": dense_init(gen, d, 2 * n, dtype),           # -> (B, C)
        "w_dt": dense_init(gen, d, di, dtype, scale=0.01),
        "conv_w": (conv * 0.1).to(dtype),
        "a_log": torch.zeros((di,), dtype=torch.float32,     # A = -exp(a_log)
                             device=gen.device),
        "d_skip": torch.ones((di,), dtype=dtype, device=gen.device),
        "w_out": dense_init(gen, di, d, dtype),
        "norm": rmsnorm_init(d, dtype, gen.device),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """u [B,S,di], w [K,di]; returns conv + final (K-1)-tap state.  The K
    products are summed by Python's ``sum`` from 0 in the working type, as
    in the reference."""
    k = w.shape[0]
    if state is None:
        state = u.new_zeros((u.shape[0], k - 1, u.shape[2]))
    padded = torch.cat([state, u], dim=1)
    out = sum(padded[:, i:i + u.shape[1], :] * w[i] for i in range(k))
    new_state = padded[:, -(k - 1):, :] if k > 1 else state
    return out, new_state


def mamba_apply(p: Params, cfg: ArchConfig, x: torch.Tensor,
                state: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Dict]:
    """Selective SSM.  state = {"h" [B,di,N] fp32, "conv" [B,K-1,di]}."""
    b, s, d = x.shape
    di = cfg.ssm_expand * d
    n = cfg.ssm_state
    xn = rmsnorm(x, p["norm"], cfg.norm_eps)
    uz = xn @ p["w_in"]
    u, z = uz[..., :di], uz[..., di:]
    # on DTensors, each step's inputs are laid out once before the loop
    # (B and C whole on each rank, Δ and u over the channels, as the
    # state): a step's slice of a partial sum would be reduced every step
    bc = _maybe_shard(xn @ p["w_bc"], (data_axes() or None, None, None))
    bmat, cmat = bc[..., :n].float(), bc[..., n:].float()     # [B,S,N]
    dt = shard_tokens(softplus((xn @ p["w_dt"]).float()))     # [B,S,di]
    u, conv_state = _causal_conv(u, p["conv_w"],
                                 state["conv"] if state else None)
    u = F.silu(u)
    a = -torch.exp(p["a_log"])                                # [di]

    h = (state["h"] if state else
         x.new_zeros((b, di, n), dtype=torch.float32))
    u32 = shard_tokens(u.float())
    ys = []
    for t in range(_steps(s)):
        dt_t = dt[:, t]
        decay = torch.exp(dt_t * a)                           # [B,di]
        h = h * decay[..., None] + (dt_t * u32[:, t])[..., None] * \
            bmat[:, t, None, :]
        ys.append((h * cmat[:, t, None, :]).sum(-1))          # [B,di]
    y = _stack_steps(ys, s).to(x.dtype)                       # [B,S,di]
    y = y + u * p["d_skip"]
    y = y * F.silu(z)
    out = y @ p["w_out"]
    return x + out, {"h": h, "conv": conv_state}


def mamba_state(cfg: ArchConfig, batch: int, device: torch.device | str,
                dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    di = cfg.ssm_expand * cfg.d_model
    return {"h": torch.zeros((batch, di, cfg.ssm_state),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_kernel - 1, di),
                                dtype=dtype, device=device)}


# -- xLSTM --------------------------------------------------------------------

def mlstm_init(gen: torch.Generator, cfg: ArchConfig,
               dtype: torch.dtype) -> Params:
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    return {
        "wq": dense_init(gen, d, d, dtype),
        "wk": dense_init(gen, d, d, dtype),
        "wv": dense_init(gen, d, d, dtype),
        "w_if": dense_init(gen, d, 2 * h, dtype, scale=0.02),
        "wo": dense_init(gen, d, d, dtype),
        "norm": rmsnorm_init(d, dtype, gen.device),
        "out_norm": rmsnorm_init(dh, dtype, gen.device),
    }


def mlstm_apply(p: Params, cfg: ArchConfig, x: torch.Tensor,
                state: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Dict]:
    """Matrix-memory LSTM: C_t = f C + i v k^T;  y = C q / max(|n.q|, 1).

    state = {"c" [B,H,dh,dh], "n" [B,H,dh], "m" [B,H]} (m = log-stabilizer),
    all fp32."""
    b, s, d = x.shape
    h = cfg.n_heads
    dh = d // h
    xn = rmsnorm(x, p["norm"], cfg.norm_eps)
    q = split_heads(xn @ p["wq"], h, dh).float()
    k = split_heads(xn @ p["wk"], h, dh).float() / math.sqrt(dh)
    v = split_heads(xn @ p["wv"], h, dh).float()
    gi, gf = (xn @ p["w_if"]).float().chunk(2, dim=-1)         # [B,S,H]

    if state is None:
        c = x.new_zeros((b, h, dh, dh), dtype=torch.float32)
        n = x.new_zeros((b, h, dh), dtype=torch.float32)
        m = x.new_zeros((b, h), dtype=torch.float32)
    else:
        c, n, m = state["c"], state["n"], state["m"]

    ys = []
    for t in range(_steps(s)):
        q_t, k_t, v_t = q[:, t], k[:, t], v[:, t]
        i_t, f_t = gi[:, t], gf[:, t]
        logf = -softplus(-f_t)                               # log sigmoid(f)
        m_new = torch.maximum(logf + m, i_t)
        fgate = torch.exp(logf + m - m_new)                  # [B,H]
        igate = torch.exp(i_t - m_new)
        c = c * fgate[..., None, None] + \
            igate[..., None, None] * (v_t[..., :, None] * k_t[..., None, :])
        n = n * fgate[..., None] + igate[..., None] * k_t
        denom = torch.clamp_min(torch.abs((n * q_t).sum(-1)), 1.0)  # [B,H]
        ys.append((c * q_t[..., None, :]).sum(-1) / denom[..., None])
        m = m_new
    y = _stack_steps(ys, s)                                  # [B,S,H,dh]
    y = rmsnorm(y.to(x.dtype), p["out_norm"], cfg.norm_eps)
    out = merge_heads(y) @ p["wo"]
    return x + out, {"c": c, "n": n, "m": m}


def mlstm_state(cfg: ArchConfig, batch: int, device: torch.device | str
                ) -> Dict[str, torch.Tensor]:
    h = cfg.n_heads
    dh = cfg.d_model // h

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return {"c": zeros(batch, h, dh, dh), "n": zeros(batch, h, dh),
            "m": zeros(batch, h)}


def slstm_init(gen: torch.Generator, cfg: ArchConfig,
               dtype: torch.dtype) -> Params:
    d = cfg.d_model
    return {
        "w_gates": dense_init(gen, d, 4 * d, dtype),         # i, f, z, o
        "r_gates": dense_init(gen, d, 4 * d, dtype, scale=0.02),
        "wo": dense_init(gen, d, d, dtype),
        "norm": rmsnorm_init(d, dtype, gen.device),
    }


def slstm_apply(p: Params, cfg: ArchConfig, x: torch.Tensor,
                state: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Dict]:
    """Scalar-memory LSTM with exponential gating and recurrent connection.

    state = {"c","n","hid","m" [B,D]}, all fp32.  The recurrent product
    ``hid @ r_gates`` is fp32 (on the card, TF32 must stay off for the
    reference's numbers)."""
    b, s, d = x.shape
    xn = rmsnorm(x, p["norm"], cfg.norm_eps)
    wx = (xn @ p["w_gates"]).float()                         # [B,S,4D]

    if state is None:
        z = x.new_zeros((b, d), dtype=torch.float32)
        c, n, hid, m = z, z, z, z
    else:
        c, n, hid, m = state["c"], state["n"], state["hid"], state["m"]

    r_gates = p["r_gates"].float()
    ys = []
    for t in range(_steps(s)):
        g = wx[:, t] + hid @ r_gates
        gi, gf, gz, go = g.chunk(4, dim=-1)
        logf = -softplus(-gf)
        m_new = torch.maximum(logf + m, gi)
        fgate = torch.exp(logf + m - m_new)
        igate = torch.exp(gi - m_new)
        c = fgate * c + igate * torch.tanh(gz)
        n = fgate * n + igate
        hid = torch.sigmoid(go) * c / torch.clamp_min(n, 1.0)
        m = m_new
        ys.append(hid)
    y = _stack_steps(ys, s).to(x.dtype)
    out = y @ p["wo"]
    return x + out, {"c": c, "n": n, "hid": hid, "m": m}


def slstm_state(cfg: ArchConfig, batch: int, device: torch.device | str
                ) -> Dict[str, torch.Tensor]:
    def zeros():
        return torch.zeros((batch, cfg.d_model), dtype=torch.float32,
                           device=device)
    return {"c": zeros(), "n": zeros(), "hid": zeros(), "m": zeros()}
