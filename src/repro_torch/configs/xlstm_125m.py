"""xlstm-125m [ssm]: 12L d_model=768 4H d_ff=0 vocab=50304 — alternating
sLSTM + mLSTM blocks (1:1), no FFN.  [arXiv:2405.04517; unverified]"""
from repro_torch.models.config import ArchConfig

_pattern = tuple("mlstm" if i % 2 == 0 else "slstm" for i in range(12))

CONFIG = ArchConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    block_pattern=_pattern,
    tie_embeddings=True,
    source="arXiv:2405.04517; unverified",
)
