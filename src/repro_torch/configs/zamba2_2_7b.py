"""zamba2-2.7b [arXiv:2411.15242]: Mamba2 backbone + one shared full
transformer block applied every 6th layer (shared weights, per-application
KV caches)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32_000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    attn_every=6,
    tie_embeddings=True,
    max_seq=524_288,
)
