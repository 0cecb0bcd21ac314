"""AdamW from scratch (port of the JAX package's ``training/optimizer.py``):
bias correction, decoupled weight decay, global-norm clipping, cosine
schedule with linear warmup. Moments are float32 regardless of param dtype.

Plain functions on ordered dicts of tensors keyed by the port's parameter
names (``blocks.3.attn.wq``). ``apply`` updates the parameters and the
moments in place, under ``no_grad``, with ``torch._foreach_*`` ops: a few
launches for all leaves, not a dozen a leaf. The step counter and the
schedule live on the host (numpy float32, the reference's arithmetic), so
an update never reads the card.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.models.transformer import STACKED

F32 = np.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor  # scalar int32, on the host
    mu: dict  # first moments (f32), by parameter name
    nu: dict  # second moments (f32)


def init(params: Mapping) -> AdamWState:
    def zeros():
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in params.items()}

    return AdamWState(step=torch.zeros((), dtype=torch.int32), mu=zeros(), nu=zeros())


def schedule(cfg: AdamWConfig, step) -> float:
    """The learning rate at ``step`` (an int or a scalar tensor), in float32
    as the reference computes it."""
    step = F32(int(step))
    warm = min(step / F32(max(cfg.warmup_steps, 1)), F32(1.0))
    prog = np.clip((step - F32(cfg.warmup_steps))
                   / F32(max(cfg.total_steps - cfg.warmup_steps, 1)), F32(0.0), F32(1.0))
    cos = F32(0.5) * (F32(1.0) + np.cos(F32(np.pi) * prog))
    floor = F32(cfg.min_lr_ratio)
    return float(F32(cfg.learning_rate) * warm * (floor + F32(1.0 - cfg.min_lr_ratio) * cos))


def global_norm(tensors) -> torch.Tensor:
    """sqrt(Σ x²) over every element of every tensor, in float32: a sum of
    squares a tensor, as the reference adds them (torch's ``norm`` on the
    CPU, ``_foreach_norm`` included, is off by ~1e-5 relative at 10^5
    elements; ``sum`` adds pairwise)."""
    tensors = [x.float() for x in tensors]
    squares = torch._foreach_mul(tensors, tensors)
    return torch.sqrt(torch.stack([sq.sum() for sq in squares]).sum())


def clip_by_global_norm(grads: Mapping, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm)."""
    norm = global_norm(grads.values())
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    scaled = torch._foreach_mul(list(grads.values()), scale)
    return dict(zip(grads, scaled)), norm


def decays(name: str, p: torch.Tensor) -> bool:
    """The reference's default mask, ``ndim >= 2`` of its leaf: a leaf of a
    layer stack (``blocks.i.``/``enc_blocks.i.``) has one more dimension
    there, so a per-layer norm scale, bias or SSM vector (``(d,)`` here,
    ``(L, d)`` in the reference) decays while ``final_norm.scale`` does not.
    The reference's docstring says "matrices but not norms/biases"; its
    code decays the stacked ones, and the port keeps what the code does."""
    return p.ndim + (name.partition(".")[0] in STACKED) >= 2


def apply(cfg: AdamWConfig, params: Mapping, grads: Mapping, state: AdamWState, *,
          decay_mask: Mapping | None = None):
    """One AdamW update, in place. ``decay_mask``: {name: bool}, True =
    apply weight decay (defaults to `decays`). Returns (params, the new
    state, {"grad_norm", "lr"})."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = int(state.step) + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = float(F32(1.0) - F32(b1) ** F32(step))
    bc2 = float(F32(1.0) - F32(b2) ** F32(step))
    if decay_mask is None:
        decay_mask = {n: decays(n, p) for n, p in params.items()}

    names = list(params)
    p = [params[n] for n in names]
    g = [grads[n].float() for n in names]
    m = [state.mu[n] for n in names]
    v = [state.nu[n] for n in names]
    with torch.no_grad():
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, g, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, g, g, value=1 - b2)
        del g
        den = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, cfg.eps)
        delta = torch._foreach_div(m, bc1)
        torch._foreach_div_(delta, den)
        del den
        if cfg.weight_decay:
            dec = [i for i, n in enumerate(names) if decay_mask[n]]
            if dec:
                torch._foreach_add_([delta[i] for i in dec], [p[i].float() for i in dec],
                                    alpha=cfg.weight_decay)
        torch._foreach_add_(p, [d.to(x.dtype) for d, x in zip(delta, p)], alpha=-lr)
    new = AdamWState(step=torch.tensor(step, dtype=torch.int32), mu=state.mu, nu=state.nu)
    return params, new, {"grad_norm": gnorm, "lr": lr}
