"""internvl2-2b [arXiv:2404.16821]: InternViT frontend (STUB — input_specs
provides precomputed patch embeddings) + InternLM2-2b text backbone."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92_553,
    tie_embeddings=False,
    rope_theta=1_000_000.0,
    frontend="vision_stub",
    frontend_seq=256,  # patch embeddings per image (stub)
    frontend_dim=2048,
    max_seq=32_768,
)
