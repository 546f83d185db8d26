"""gemma3-4b [hf:google/gemma-3]: 34L d=2560 8H GQA kv=4, 5:1 local:global
sliding window (1024), 128k context, qk-norm, 262k vocab."""

from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    d_ff=10_240,
    vocab=262_144,
    d_head=256,
    rope_theta=1_000_000.0,
    local_global_period=6,        # 5 local + 1 global
    sliding_window=1024,
    qk_norm=True,
    tie_embeddings=True,
    act="gelu",
    remat="full",
)

SMOKE = reduced(CONFIG, local_global_period=2, n_layers=4)
