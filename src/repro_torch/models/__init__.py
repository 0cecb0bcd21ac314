from repro_torch.models.config import ModelConfig, reduced
from repro_torch.models.model import Model, build_model

__all__ = ["ModelConfig", "reduced", "Model", "build_model"]
