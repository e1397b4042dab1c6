"""seamless-m4t-medium [audio]: 12L d_model=1024 16H (GQA kv=16) d_ff=4096
vocab=256206 — encoder-decoder; the speech frontend is a STUB
(input_specs provides precomputed frame embeddings).  [arXiv:2308.11596; hf]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256206,
    enc_layers=12, frontend="audio_frames",
    block_pattern=tuple(["xdec"] * 12),
    tie_embeddings=True,
    source="arXiv:2308.11596; hf",
)
