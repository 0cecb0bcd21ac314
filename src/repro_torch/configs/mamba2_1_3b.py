"""mamba2-1.3b [arXiv:2405.21060]: attention-free SSD (state-space duality).
d_inner = 2*2048, 64 heads of P=64, N=128 state."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    tie_embeddings=True,
    max_seq=524_288,
)
