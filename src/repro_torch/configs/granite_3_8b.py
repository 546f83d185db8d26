"""granite-3-8b [hf:ibm-granite/granite-3.0]: 40L d=4096 32H GQA kv=8."""

from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12_800,
    vocab=49_155,
    d_head=128,
    rope_theta=10_000.0,
    tie_embeddings=True,
    remat="full",
)

SMOKE = reduced(CONFIG)
