"""arctic-480b [hf:Snowflake/snowflake-arctic-base]: 128-expert top-2 MoE
with a dense residual FFN in parallel (dense-MoE hybrid)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32_000,
    n_experts=128,
    experts_per_token=2,
    moe_dense_residual=True,
    tie_embeddings=False,
    rope_theta=10_000.0,
    max_seq=4096,
)
