"""internlm2-20b [arXiv:2403.17297]: dense GQA kv=8."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92_544,
    tie_embeddings=False,
    rope_theta=1_000_000.0,
    max_seq=32_768,
)
