"""llava-next-34b [hf:llava-hf/llava-v1.6]: 60L d=7168 56H GQA kv=8 backbone
(Yi-34B-class); anyres vision tiling is a STUB — input_specs() supplies
precomputed patch embeddings (up to 2880 tokens) prepended to the text."""

from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20_480,
    vocab=64_000,
    d_head=128,
    rope_theta=5_000_000.0,
    frontend="vision_patches",
    n_frontend_tokens=2_880,
    tie_embeddings=False,
    param_dtype="bfloat16",
    opt_dtype="bfloat16",
    remat="full",
)

SMOKE = reduced(CONFIG)
