"""moonshot-v1-16b-a3b [hf:moonshotai/Moonlight-16B-A3B]: MoE 64 experts
top-6, d_ff=1408 per expert."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163_840,
    n_experts=64,
    experts_per_token=6,
    tie_embeddings=True,
    rope_theta=50_000.0,
    max_seq=32_768,
)
