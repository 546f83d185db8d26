"""whisper-base [arXiv:2212.04356]: enc-dec, 6+6L, d=512, 8H MHA, ff=2048.
Audio conv frontend is a STUB: input_specs() supplies precomputed frame
embeddings (see DESIGN.md §4)."""

from repro_torch.models.config import ModelConfig, reduced

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51_865,
    d_head=64,
    is_encdec=True,
    n_enc_layers=6,
    frontend="audio_frames",
    n_frontend_tokens=1_500,
    tie_embeddings=True,
    act="gelu",
    remat="full",
)

SMOKE = reduced(CONFIG)
