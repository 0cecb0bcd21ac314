"""gemma3-27b [hf:google/gemma-3-27b-pt]: dense, 5:1 local:global, 128k."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262_144,
    tie_embeddings=True,
    sliding_window=1024,
    global_every=6,
    rope_theta=1_000_000.0,
    max_seq=131_072,
)
