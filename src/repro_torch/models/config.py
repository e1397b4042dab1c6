"""Architecture configuration schema covering all 10 assigned families.

One :class:`ArchConfig` describes any supported architecture: dense GQA
transformers (with optional qk-norm), MoE (standard top-k and DeepSeek-V2
style MLA + shared experts), Mamba2/attention hybrids, xLSTM stacks,
encoder-decoder (audio) and VLM backbones with M-RoPE.  ``reduced()``
returns the family-preserving small config used by CPU smoke tests.

A copy of the JAX package's schema, field for field (the tests hold the
two equal), followed by the port's own fields: a leading dense stack,
DeepSeek-V2's group-limited routing over a device's share of the experts,
and YaRN for MLA's rotary part.  Their defaults change nothing of a
shipped config.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None      # default d_model // n_heads

    # normalization / attention details
    qk_norm: bool = False             # qwen3-style per-head q/k RMSNorm
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = True
    mrope: bool = False               # qwen2-vl multimodal rotary (3D pos)

    # MoE
    moe: bool = False
    n_experts: int = 0
    experts_per_tok: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0                 # per-expert FFN width (fine-grained)

    # MLA (deepseek-v2)
    mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64

    # hybrid / ssm
    block_pattern: Tuple[str, ...] = ()   # per-layer: attn|moe|mamba|mlstm|slstm
    ssm_state: int = 0
    ssm_expand: int = 2
    conv_kernel: int = 4
    shared_attn_every: int = 0        # zamba2: shared attn block cadence

    # encoder-decoder (seamless-m4t)
    enc_layers: int = 0               # 0 => decoder-only
    frontend: str = "none"            # none | audio_frames | vision_patches

    # training
    schedule: str = "cosine"          # wsd | cosine
    remat: bool = True
    dtype: str = "bfloat16"

    # provenance
    source: str = ""

    # -- the port's own fields (none in the JAX package's schema); their
    # defaults leave every shipped config as the JAX package has it
    first_dense: int = 0              # leading dense layers of an MoE stack
    # DeepSeek-V2's routing (``models/layers.py`` ``moe_held_apply``): a
    # softmax router over ``router_experts`` (0: the JAX package's top-k
    # MoE over ``n_experts``) of which this device holds ``n_experts``,
    # from ``expert_offset`` on
    router_experts: int = 0
    expert_offset: int = 0
    n_group: int = 0                  # expert groups; 0: no group limit
    topk_group: int = 0               # groups a token may route to
    routed_scaling: float = 1.0       # the routed experts' weight factor
    # YaRN scaling of MLA's rotary part; factor 0: plain RoPE
    yarn_factor: float = 0.0
    yarn_original_max: int = 4096
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale: float = 1.0
    yarn_mscale_all_dim: float = 0.0

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def pattern(self) -> Tuple[str, ...]:
        if self.block_pattern:
            return self.block_pattern
        if self.moe:
            return (("attn",) * self.first_dense
                    + ("moe",) * (self.n_layers - self.first_dense))
        return tuple(["attn"] * self.n_layers)

    @property
    def held_experts(self) -> bool:
        """The MoE layers route over ``router_experts`` with DeepSeek-V2's
        rule and compute the held experts' share (``moe_held_apply``)."""
        return self.moe and self.router_experts > 0

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k decode shape (SSM/hybrid/linear)."""
        return any(b in ("mamba", "mlstm", "slstm") for b in self.pattern)

    @property
    def has_decoder(self) -> bool:
        return True   # all assigned archs decode (seamless is enc-dec)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, dh = self.d_model, self.head_dim
        n = self.vocab * d
        if not self.tie_embeddings:
            n += self.vocab * d
        for blk in self.pattern:
            if blk in ("attn", "moe"):
                if self.mla:
                    n += d * (self.kv_lora_rank + self.rope_head_dim)
                    n += self.kv_lora_rank * self.n_heads * (dh + self.rope_head_dim)
                    if self.q_lora_rank:
                        n += d * self.q_lora_rank + self.q_lora_rank * self.n_heads * dh
                    else:
                        n += d * self.n_heads * dh
                    n += self.n_heads * dh * d
                else:
                    n += d * self.n_heads * dh + 2 * d * self.n_kv_heads * dh
                    n += self.n_heads * dh * d
                if blk == "moe":
                    ff = self.moe_d_ff or self.d_ff
                    n += self.n_experts * 3 * d * ff
                    n += self.n_shared_experts * 3 * d * ff
                    n += d * (self.router_experts or self.n_experts)
                else:
                    n += 3 * d * self.d_ff
            elif blk == "mamba":
                di = self.ssm_expand * d
                n += d * 2 * di + di * d + di * (2 * self.ssm_state + 2)
            elif blk in ("mlstm", "slstm"):
                n += 4 * d * d + 2 * d * self.d_ff if self.d_ff else 5 * d * d
        if self.enc_layers:
            # encoder blocks + cross-attention in decoder
            n += self.enc_layers * (4 * d * d + 3 * d * self.d_ff)
            n += self.n_layers * 4 * d * d
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        ff = self.moe_d_ff or self.d_ff
        total = self.param_count()
        inactive = (self.n_experts - self.experts_per_tok) * 3 * d * ff
        inactive *= sum(1 for b in self.pattern if b == "moe")
        return total - inactive

    def reduced(self) -> "ArchConfig":
        """Family-preserving tiny config for CPU smoke tests."""
        def cut(v, lo, f=8):
            return max(lo, v // f)
        pat = self.pattern[: max(2, min(4, len(self.pattern)))]
        n_heads = max(2, self.n_heads // 8)
        n_kv = max(1, min(n_heads, self.n_kv_heads // 8 or 1))
        return dataclasses.replace(
            self,
            n_layers=len(pat),
            block_pattern=pat,
            d_model=max(64, self.d_model // 16),
            n_heads=n_heads,
            n_kv_heads=n_kv,
            d_head=max(16, self.head_dim // 4),
            d_ff=max(128, self.d_ff // 16) if self.d_ff else 0,
            vocab=512,
            n_experts=min(4, self.n_experts) if self.moe else 0,
            experts_per_tok=min(2, self.experts_per_tok) if self.moe else 0,
            n_shared_experts=min(1, self.n_shared_experts),
            moe_d_ff=max(64, self.moe_d_ff // 8) if self.moe_d_ff else 0,
            kv_lora_rank=64 if self.mla else 0,
            q_lora_rank=64 if (self.mla and self.q_lora_rank) else 0,
            rope_head_dim=16 if self.mla else 64,
            ssm_state=min(16, self.ssm_state) if self.ssm_state else 0,
            enc_layers=min(2, self.enc_layers),
            remat=False,
        )
