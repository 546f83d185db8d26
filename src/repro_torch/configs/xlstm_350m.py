"""xlstm-350m [arXiv:2405.04517]: 24L d=1024 4H, sLSTM + mLSTM blocks
(3 mLSTM : 1 sLSTM interleave; d_ff=0 — projections live inside the blocks)."""

from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50_304,
    slstm_every=4,
    slstm_offset=3,
    tie_embeddings=True,
    remat="full",
)

SMOKE = reduced(CONFIG, d_model=64, n_heads=2)
