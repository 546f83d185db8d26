"""deepseek-v2-236b [arXiv:2405.04434]: 60L d=5120 128H MLA (kv_lora=512,
q_lora=1536, rope head 64), 2 shared + 160 routed experts top-6, first layer
dense (d_ff 12288), expert d_ff=1536, vocab 102400."""

from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=12_288,                  # dense layers (first_k_dense)
    vocab=102_400,
    d_head=128,                   # nope head dim
    v_head_dim=128,
    kv_lora_rank=512,
    q_lora_rank=1536,
    rope_head_dim=64,
    n_experts=160,
    n_shared_experts=2,
    top_k=6,
    d_ff_expert=1536,
    first_k_dense=1,
    moe_every=1,
    moe_offset=0,
    tie_embeddings=False,
    param_dtype="bfloat16",
    opt_dtype="bfloat16",
    remat="full",
)

SMOKE = reduced(CONFIG, n_heads=4, n_kv_heads=4)
