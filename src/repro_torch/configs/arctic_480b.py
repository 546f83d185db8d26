"""arctic-480b [hf:Snowflake/snowflake-arctic-base]: 35L d=7168 56H GQA kv=8,
128 experts top-2 (d_ff 4864) + dense residual MLP in parallel."""

from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,                    # the parallel dense residual MLP
    vocab=32_000,
    d_head=128,
    n_experts=128,
    top_k=2,
    d_ff_expert=4864,
    moe_every=1,
    moe_offset=0,
    tie_embeddings=False,
    param_dtype="bfloat16",
    opt_dtype="bfloat16",
    remat="full",
)

SMOKE = reduced(CONFIG)
