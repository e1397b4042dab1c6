"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=32000, ssm_state=64 — Mamba2 backbone + shared attention block
applied every 6 layers.  [arXiv:2411.15242; hf]"""
from repro_torch.models.config import ArchConfig

_pattern = []
for i in range(38):
    _pattern.append("mamba")
    if (i + 1) % 6 == 0:
        _pattern.append("sattn")       # shared attention block (re-used params)

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32000,
    block_pattern=tuple(_pattern),
    ssm_state=64, ssm_expand=2, conv_kernel=4, shared_attn_every=6,
    tie_embeddings=True,
    source="arXiv:2411.15242; hf",
)
