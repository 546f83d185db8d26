"""jamba-v0.1-52b [arXiv:2403.19887]: 32L d=4096, Mamba+attn 1:7 interleave,
MoE 16e top-2 every other layer, GQA kv=8, vocab 65536."""

from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14_336,
    vocab=65_536,
    d_head=128,
    attn_every=8,                 # 1 attention : 7 mamba
    attn_offset=4,
    n_experts=16,
    top_k=2,
    d_ff_expert=14_336,
    moe_every=2,                  # MoE every other layer
    moe_offset=1,
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    tie_embeddings=False,
    param_dtype="bfloat16",
    opt_dtype="bfloat16",
    remat="full",
)

SMOKE = reduced(CONFIG, attn_every=2, attn_offset=1, moe_every=2, moe_offset=0,
                n_layers=4)
