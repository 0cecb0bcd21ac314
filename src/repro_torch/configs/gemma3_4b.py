"""gemma3-4b [hf:google/gemma-3-*-pt]: dense, 5:1 local:global sliding
window, 128k context. head_dim=256 (decoupled from d_model/n_heads)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262_144,
    tie_embeddings=True,
    sliding_window=1024,
    global_every=6,  # layers 5, 11, ... are global → 5 local : 1 global
    rope_theta=1_000_000.0,
    max_seq=131_072,
)
