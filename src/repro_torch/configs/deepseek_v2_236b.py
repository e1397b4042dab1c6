"""deepseek-v2-236b [moe]: 60L d_model=5120 128H (GQA kv=128) d_ff=1536
vocab=102400, MoE 160 routed experts top-6 + 2 shared, MLA kv_lora=512.
[arXiv:2405.04434; hf]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=1536, vocab=102400, d_head=128,
    moe=True, n_experts=160, experts_per_tok=6, n_shared_experts=2,
    moe_d_ff=1536,
    mla=True, kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
    tie_embeddings=False,
    source="arXiv:2405.04434; hf",
)
