"""llama2-7b — the paper's own evaluated model (§5.4: INT8 LLaMA2-7B
inference and training via llama2.c [308]).  Not part of the assigned
10-arch pool; selectable for dry-runs and the simulator workloads."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama2-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=11008, vocab=32000,
    tie_embeddings=False,
    source="arXiv:2307.09288; github.com/karpathy/llama2.c",
)
