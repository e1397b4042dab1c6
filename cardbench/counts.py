"""The yardstick's arithmetic, frozen with the benchmark: the H100's peaks,
the model flops of a prefill, and K6's operations and bytes.  Every count depends on the configuration's shapes alone, so
it stays the same whatever implements the work.

Peaks: NVIDIA H100 SXM data sheet, dense: 989 TFLOP/s bf16 and fp16 on
the tensor cores, 67 TFLOP/s fp32 on the CUDA cores (TF32 off), HBM3 at
3.35 TB/s, all at the 700 W power limit.  A run prints the card's
``power.limit`` beside them.

The peaks, :func:`k6_call` and :func:`causal_attention_flops` are the
yardstick every family shares; the rest counts the dense, Mamba2 and
shared-block family (``layouts/lm.py``), and another family counts its
own in its layout module.

Model flops count each weight a token is multiplied by (every block as
the pattern applies it, a shared block at each application, the LM head;
the embedding lookup is no product), the causal attention products (q·k
and p·v over the S(S+1)/2 pairs a causal sequence has), and the Mamba2
scan's recurrence (5 flops per channel and state entry a token: decay,
input, update, read-out and its sum).
"""
from __future__ import annotations

from typing import Dict, List

PEAK_FLOPS: Dict[str, float] = {"bfloat16": 989e12, "float16": 989e12,
                                "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}
K6_KERNEL = "flash_attn_mma_kernel"   # K6's bf16 kernel, by its name
ATTENTION_KINDS = ("attn", "sattn")


def pattern(arch: dict) -> List[str]:
    return list(arch.get("block_pattern") or ["attn"] * arch["n_layers"])


def head_dim(arch: dict) -> int:
    return arch.get("d_head") or arch["d_model"] // arch["n_heads"]


def _attention_block_weights(arch: dict) -> int:
    d, dh = arch["d_model"], head_dim(arch)
    h, hkv = arch["n_heads"], arch["n_kv_heads"]
    return d * h * dh + 2 * d * hkv * dh + h * dh * d + 3 * d * arch["d_ff"]


def _mamba_weights(arch: dict) -> int:
    d = arch["d_model"]
    di = arch["ssm_expand"] * d
    n = arch["ssm_state"]
    return d * 2 * di + d * 2 * n + d * di + di * d


def weights_per_token(arch: dict) -> int:
    """Weights a token is multiplied by in one forward pass."""
    per_kind = {"attn": _attention_block_weights, "sattn":
                _attention_block_weights, "mamba": _mamba_weights}
    total = sum(per_kind[kind](arch) for kind in pattern(arch))
    return total + arch["d_model"] * arch["vocab"]


def scan_flops_per_token(arch: dict) -> int:
    di = arch.get("ssm_expand", 0) * arch["d_model"]
    per_layer = 5 * di * arch.get("ssm_state", 0)
    return per_layer * sum(1 for kind in pattern(arch) if kind == "mamba")


def attention_layers(arch: dict) -> int:
    return sum(1 for kind in pattern(arch) if kind in ATTENTION_KINDS)


def causal_attention_flops(arch: dict, batch: int, seq: int) -> int:
    """q·k and p·v over a causal sequence's S(S+1)/2 pairs, each pair
    2·dh flops a product, for every head of one layer."""
    heads = batch * arch["n_heads"]
    return 2 * heads * head_dim(arch) * seq * (seq + 1)


def forward_flops(arch: dict, batch: int, seq: int) -> int:
    tokens = batch * seq
    return (2 * weights_per_token(arch) * tokens
            + scan_flops_per_token(arch) * tokens
            + attention_layers(arch) * causal_attention_flops(arch, batch,
                                                              seq))


def prefill_flops(arch: dict, batch: int, seq: int) -> int:
    return forward_flops(arch, batch, seq)


def k6_call(arch: dict, batch: int, seq: int) -> Dict[str, float]:
    """One K6 call of a prefill of ``batch`` prompts of ``seq`` tokens:
    its flops, its bytes (q, k, v and o once each, in the working type)
    and its least time on the H100, the larger of the two bounds."""
    heads = batch * arch["n_heads"]
    flops = causal_attention_flops(arch, batch, seq)
    nbytes = 4 * heads * seq * head_dim(arch) * ITEMSIZE[arch["dtype"]]
    t_flops = flops / PEAK_FLOPS[arch["dtype"]]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return {"flops": flops, "bytes": nbytes,
            "bound_s": max(t_flops, t_bytes),
            "by": "flops" if t_flops >= t_bytes else "bytes"}


def k6_calls_per_prefill(arch: dict) -> int:
    return attention_layers(arch)
