"""Device resolution for the port's entry points.

Entry points default to ``"cuda"`` and raise when CUDA is missing: there
is no silent move to the CPU. The CPU runs the plain PyTorch versions of
every kernel, and only when the caller asks for it.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """The device an entry point runs on; raises if it is a missing GPU.

    Also pins float32 matrix products to full f32 (no TF32): the reference
    computes in f32 with f32 accumulation, and TF32 keeps ~3 digits.
    """
    dev = torch.device("cuda" if device is None else device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch versions")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
