"""tinyllama-1.1b [arXiv:2401.02385]: llama2-arch, 22L d=2048 32H GQA kv=4."""

from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=5632,
    vocab=32_000,
    d_head=64,
    rope_theta=10_000.0,
    tie_embeddings=False,
    remat="full",
)

SMOKE = reduced(CONFIG)
