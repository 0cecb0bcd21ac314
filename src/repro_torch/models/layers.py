"""Primitive layers: norms, RoPE, initializers, MLPs (port of the JAX
package's ``models/layers.py``).

Each layer is a parameter holder (an ``nn.Module`` whose parameters carry
the reference's leaf names and tensor layouts, so every einsum string
carries over unchanged) plus a plain function ``apply(params, x, ...)``.
A module is built empty, on any device (``"meta"`` allocates nothing), and
filled by ``reset(gen)`` from an explicit ``torch.Generator``.

The reference's GSPMD hints (``shard_hint``, ``configure_shard_hints``)
are no-ops on one device; they come with the LM-sharding slice.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


# ----------------------------------------------------------------- inits --
def empty_param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


def normal_(p: torch.Tensor, gen: torch.Generator, scale: float = 0.02) -> None:
    """N(0, scale²) drawn in place (no temporary the size of ``p``)."""
    with torch.no_grad():
        p.normal_(0.0, scale, generator=gen)


def fill_(p: torch.Tensor, value: float) -> None:
    with torch.no_grad():
        p.fill_(value)


# ----------------------------------------------------------------- norms --
class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype, device=None):
        super().__init__()
        self.scale = empty_param((d,), dtype, device)

    def reset(self, gen=None) -> None:
        fill_(self.scale, 1.0)


class LayerNorm(nn.Module):
    def __init__(self, d: int, dtype, device=None):
        super().__init__()
        self.scale = empty_param((d,), dtype, device)
        self.bias = empty_param((d,), dtype, device)

    def reset(self, gen=None) -> None:
        fill_(self.scale, 1.0)
        fill_(self.bias, 0.0)


def rmsnorm(params, x, eps: float = 1e-6):
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params.scale.float()).to(dt)


def layernorm(params, x, eps: float = 1e-5):
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)  # jnp.var: population
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params.scale.float() + params.bias.float()).to(dt)


# ------------------------------------------------------------------ RoPE --
def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    """In numpy float32, as the reference computes it: the same bits."""
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) * 2.0 / head_dim))


@functools.lru_cache(maxsize=32)
def _rope_tables(head_dim: int, theta: float, device: torch.device):
    """(frequencies (hd/2,), signs [-1…, 1…] (hd,)) on ``device``, copied
    up once: a copy from pageable host memory a call would wait for the
    card's stream on every decode step."""
    freqs = torch.from_numpy(rope_frequencies(head_dim, theta)).to(device)
    sign = torch.ones(head_dim)
    sign[: head_dim // 2] = -1.0
    return freqs, sign.to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S).

    The reference's rotate-half form by a roll with full-width cos/sin
    tables: out = x·cos + roll(x, hd/2)·[-1…, 1…]·sin."""
    hd = x.shape[-1]
    freqs, sign = _rope_tables(hd, float(theta), x.device)
    angles = positions[..., None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)
    cos = torch.cat([cos, cos], dim=-1)[..., None, :]  # (..., S, 1, hd)
    sin = torch.sin(angles)
    sin = torch.cat([sin, sin], dim=-1)[..., None, :]
    xf = x.float()
    rot = torch.roll(xf, hd // 2, dims=-1) * sign  # [-x2, x1]
    return (xf * cos + rot * sin).to(x.dtype)


# ------------------------------------------------------------------- MLP --
class MLP(nn.Module):
    """SwiGLU (``act="silu"``: w_gate, w_up, w_down) or a plain MLP with
    biases (``"gelu"``, whisper: w_up, b_up, w_down, b_down)."""

    def __init__(self, d: int, f: int, act: str, dtype, device=None):
        super().__init__()
        self.act = act
        if act == "silu":
            self.w_gate = empty_param((d, f), dtype, device)
            self.w_up = empty_param((d, f), dtype, device)
            self.w_down = empty_param((f, d), dtype, device)
        else:
            self.w_up = empty_param((d, f), dtype, device)
            self.b_up = empty_param((f,), dtype, device)
            self.w_down = empty_param((f, d), dtype, device)
            self.b_down = empty_param((d,), dtype, device)

    def reset(self, gen) -> None:
        if self.act == "silu":
            for w in (self.w_gate, self.w_up, self.w_down):
                normal_(w, gen)
            return
        normal_(self.w_up, gen)
        normal_(self.w_down, gen)
        fill_(self.b_up, 0.0)
        fill_(self.b_down, 0.0)


def mlp_apply(params, x, act: str):
    if act == "silu":
        g = torch.matmul(x, params.w_gate)
        u = torch.matmul(x, params.w_up)
        return torch.matmul(F.silu(g) * u, params.w_down)
    h = torch.matmul(x, params.w_up) + params.b_up
    h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default is the tanh form
    return torch.matmul(h, params.w_down) + params.b_down


# ------------------------------------------------------------- embedding --
class Embedding(nn.Module):
    def __init__(self, vocab: int, d: int, dtype, device=None):
        super().__init__()
        self.table = empty_param((vocab, d), dtype, device)

    def reset(self, gen) -> None:
        normal_(self.table, gen, scale=0.01)


def embed(params, tokens):
    return params.table[tokens]


def unembed(params, x, tied_table=None):
    table = tied_table if tied_table is not None else params.table
    return torch.matmul(x, table.t())
