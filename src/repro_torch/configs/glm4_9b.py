"""glm4-9b [hf:THUDM/glm-4-9b]: 40L d=4096 32H GQA kv=2, RoPE, vocab 151552."""

from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13_696,
    vocab=151_552,
    d_head=128,
    rope_theta=10_000.0,
    tie_embeddings=False,
    remat="full",
)

SMOKE = reduced(CONFIG)
