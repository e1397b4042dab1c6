"""DeepSeek-V2's family: MLA in every layer, the dense SwiGLU MLP in the
leading ``first_dense`` layers and DeepSeekMoE (a router over all
``router_experts``, the ``n_experts`` held here stacked ``[E, ...]``, and
the shared experts as one MLP of their summed width) in the rest, an
untied head.  The parameter tree of the program's ``init_params`` for such
a configuration, its model flops, and K6's work at MLA's widths.

Model flops count each weight a token is multiplied by, as the program
applies it: every MLA projection (the up-projections of k and v too, per
token, as a prefill makes them), the dense MLP, each MoE layer's router
and shared experts, and the held experts at the expectation the shapes
alone give, ``experts_per_tok · n_experts / router_experts`` expert
applications a token; the head once a prompt (the program computes the
last position's logits only); and causal attention at ``2 (dh + rd) + 2
dh`` flops a (query, key) pair and head over the S(S+1)/2 pairs.
"""
from __future__ import annotations

from typing import Dict, List

from cardbench import counts


def pattern(arch: dict) -> List[str]:
    dense = arch.get("first_dense", 0)
    return ["attn"] * dense + ["moe"] * (arch["n_layers"] - dense)


def _mla(arch: dict) -> dict:
    d, h, dh = arch["d_model"], arch["n_heads"], arch["d_head"]
    r, rd, qr = (arch["kv_lora_rank"], arch["rope_head_dim"],
                 arch["q_lora_rank"])
    return {"w_dkv": ("fan_in", (d, r + rd)), "kv_norm": ("ones", (r,)),
            "w_uk": ("fan_in", (r, h * dh)), "w_uv": ("fan_in", (r, h * dh)),
            "wo": ("fan_in", (h * dh, d)), "w_dq": ("fan_in", (d, qr)),
            "q_norm": ("ones", (qr,)),
            "w_uq": ("fan_in", (qr, h * (dh + rd)))}


def _mlp(d: int, ff: int) -> dict:
    return {"w1": ("fan_in", (d, ff)), "w3": ("fan_in", (d, ff)),
            "w2": ("fan_in", (ff, d))}


def _moe(arch: dict) -> dict:
    d, ff, e = arch["d_model"], arch["moe_d_ff"], arch["n_experts"]
    return {"router": ("fan_in", (d, arch.get("router_experts") or e)),
            "experts": {"w1": ("fan_in", (e, d, ff)),
                        "w3": ("fan_in", (e, d, ff)),
                        "w2": ("fan_in", (e, ff, d))},
            "shared": _mlp(d, ff * arch["n_shared_experts"])}


def _scaled(group: dict, name: str, init: dict) -> dict:
    """``group`` with the fan-in factors ``init`` gives its leaves, each
    by its path under the group (``{"moe.router": 0.5}``,
    ``{"moe.experts.w2": 0.5}``)."""
    for key, factor in init.items():
        head, *path = key.split(".")
        if head != name:
            continue
        node = group
        for part in path[:-1]:
            node = node[part]
        node[path[-1]] = (("fan_in", factor), node[path[-1]][1])
    return group


def layout(arch: dict, init=None) -> dict:
    """The tree of ``(init, shape)`` pairs the program's parameters take;
    a configuration's ``init`` scales a projection's 1/sqrt(fan-in) by a
    factor, by group (``attn``, ``mlp``, ``moe``) and leaf name."""
    d, v = arch["d_model"], arch["vocab"]
    init = init or {}
    layers = []
    for kind in pattern(arch):
        block = {"ln1": ("ones", (d,)),
                 "attn": _scaled(_mla(arch), "attn", init),
                 "ln2": ("ones", (d,))}
        if kind == "moe":
            block["moe"] = _scaled(_moe(arch), "moe", init)
        else:
            block["mlp"] = _scaled(_mlp(d, arch["d_ff"]), "mlp", init)
        layers.append(block)
    return {"emb": (0.02, (v, d)), "ln_f": ("ones", (d,)),
            "unemb": ("fan_in", (d, v)), "layers": layers}


def mla_weights_per_token(arch: dict) -> int:
    d, h, dh = arch["d_model"], arch["n_heads"], arch["d_head"]
    r, rd, qr = (arch["kv_lora_rank"], arch["rope_head_dim"],
                 arch["q_lora_rank"])
    return (d * qr + qr * h * (dh + rd) + d * (r + rd) + 2 * r * h * dh
            + h * dh * d)


def moe_weights_per_token(arch: dict) -> float:
    """Router, shared experts, and the held experts at the shapes'
    expectation of applications a token."""
    d, ff, e = arch["d_model"], arch["moe_d_ff"], arch["n_experts"]
    routed = arch.get("router_experts") or e
    held = arch["experts_per_tok"] * e / routed
    return (d * routed + 3 * d * ff * arch["n_shared_experts"]
            + held * 3 * d * ff)


def attention_pair_flops(arch: dict) -> int:
    """Flops of one (query, key) pair of one head: q·k at depth dh + rd
    and p·v at width dh."""
    return 2 * (arch["d_head"] + arch["rope_head_dim"]) + 2 * arch["d_head"]


def prefill_flops(arch: dict, batch: int, seq: int) -> int:
    kinds = pattern(arch)
    per_token = (len(kinds) * mla_weights_per_token(arch)
                 + kinds.count("attn") * 3 * arch["d_model"] * arch["d_ff"]
                 + kinds.count("moe") * moe_weights_per_token(arch))
    attention = (len(kinds) * batch * arch["n_heads"] * seq * (seq + 1) // 2
                 * attention_pair_flops(arch))
    head = 2 * batch * arch["d_model"] * arch["vocab"]
    return int(2 * per_token * batch * seq) + attention + head


def k6_calls_per_prefill(arch: dict) -> int:
    """Every layer's MLA attends through K6 in a prefill."""
    return len(pattern(arch))


def k6_call(arch: dict, batch: int, seq: int) -> Dict[str, float]:
    """One K6 call of a prefill at MLA's widths: q and k at depth dh + rd,
    v and the output at width dh, in the working type; its flops, bytes
    (q, k, v and the output once each) and least time on the H100, the
    larger of the two bounds."""
    heads = batch * arch["n_heads"]
    dqk, dv = arch["d_head"] + arch["rope_head_dim"], arch["d_head"]
    flops = heads * seq * (seq + 1) // 2 * attention_pair_flops(arch)
    nbytes = heads * seq * (2 * dqk + 2 * dv) * counts.ITEMSIZE[arch["dtype"]]
    t_flops = flops / counts.PEAK_FLOPS[arch["dtype"]]
    t_bytes = nbytes / counts.HBM_BYTES_PER_S
    return {"flops": flops, "bytes": nbytes,
            "bound_s": max(t_flops, t_bytes),
            "by": "flops" if t_flops >= t_bytes else "bytes"}
