"""whisper-medium [arXiv:2212.04356]: encoder-decoder; conv audio frontend
is a STUB (input_specs supplies precomputed frame embeddings)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,  # decoder layers
    encoder_layers=24,
    is_encoder_decoder=True,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51_865,
    act="gelu",
    tie_embeddings=True,
    frontend="audio_stub",
    encoder_seq=1500,
    max_seq=32_768,
)
