"""Attention blocks: GQA with RoPE, causal/sliding-window masks, cross
attention (encoder-decoder), and single-token decode against a KV cache
(port of the JAX package's ``models/attention.py``).

The window is a static Python int (0 = global/full attention): a stack of
mixed local and global layers (gemma3's 5:1 pattern) passes each layer its
own from ``ModelConfig.layer_windows()``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from repro_torch.models import layers as L


class Attention(nn.Module):
    """Projections in the reference's layouts: wq (d, H, hd), wk and wv
    (d, Hkv, hd), wo (H, hd, d); with ``bias``, bq (H, hd), bk and bv
    (Hkv, hd)."""

    def __init__(self, d: int, n_heads: int, n_kv: int, head_dim: int, dtype,
                 bias: bool = False, device=None):
        super().__init__()
        self.wq = L.empty_param((d, n_heads, head_dim), dtype, device)
        self.wk = L.empty_param((d, n_kv, head_dim), dtype, device)
        self.wv = L.empty_param((d, n_kv, head_dim), dtype, device)
        self.wo = L.empty_param((n_heads, head_dim, d), dtype, device)
        self.has_bias = bias
        if bias:
            self.bq = L.empty_param((n_heads, head_dim), dtype, device)
            self.bk = L.empty_param((n_kv, head_dim), dtype, device)
            self.bv = L.empty_param((n_kv, head_dim), dtype, device)

    def reset(self, gen) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            L.normal_(w, gen)
        if self.has_bias:
            for b in (self.bq, self.bk, self.bv):
                L.fill_(b, 0.0)


def _project_qkv(params, x, x_kv=None):
    x_kv = x if x_kv is None else x_kv
    q = torch.einsum("bsd,dhk->bshk", x, params.wq)
    k = torch.einsum("bsd,dhk->bshk", x_kv, params.wk)
    v = torch.einsum("bsd,dhk->bshk", x_kv, params.wv)
    if params.has_bias:
        q = q + params.bq
        k = k + params.bk
        v = v + params.bv
    return q, k, v


def _gqa_scores(q, k):
    """(B,S,H,hd) × (B,T,Hkv,hd) → (B, Hkv, H/Hkv, S, T)."""
    b, s, h, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, h // hkv, hd)
    return torch.einsum("bsgrd,btgd->bgrst", qg, k)


def _gqa_out(weights, v):
    """(B,G,R,S,T) × (B,T,G,hd) → (B,S,H,hd)."""
    b, g, r, s, t = weights.shape
    out = torch.einsum("bgrst,btgd->bsgrd", weights, v)
    return out.reshape(b, s, g * r, -1)


def _masked_softmax(scores, mask, dtype):
    """Mask in f32 with -1e30, softmax, then cast to the activation dtype."""
    return torch.softmax(torch.where(mask, scores, -1e30), dim=-1).to(dtype)


def attention(
    params,
    x,
    *,
    rope_theta: float,
    window: int,  # 0 = full attention
    causal: bool = True,
    x_kv=None,
    positions=None,
    kv_positions=None,
    return_kv: bool = False,
):
    """Full-sequence attention (training / prefill).

    x: (B, S, D). Returns (B, S, D), or (out, (k, v)) with *rotated* keys
    when return_kv (what a decode-time KV cache must hold).
    Cross-attention when x_kv is given (no RoPE, whisper-style).
    """
    b, s, _ = x.shape
    is_cross = x_kv is not None
    q, k, v = _project_qkv(params, x, x_kv)
    t = k.shape[1]
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
    if not is_cross:
        q = L.apply_rope(q, positions, rope_theta)
        k = L.apply_rope(
            k, positions if kv_positions is None else kv_positions, rope_theta
        )
    scale = 1.0 / np.sqrt(q.shape[-1])
    scores = _gqa_scores(q, k).float() * scale  # (B,G,R,S,T)

    qi = positions[:, None, None, :, None]  # (B,1,1,S,1)
    ki = (
        torch.arange(t, dtype=torch.int32, device=x.device)
        if kv_positions is None
        else kv_positions[0]
    )[None, None, None, None, :]
    mask = torch.ones((b, 1, 1, s, t), dtype=torch.bool, device=x.device)
    if causal and not is_cross:
        mask = mask & (ki <= qi)
        if window:
            mask = mask & (qi - ki < window)
    weights = _masked_softmax(scores, mask, x.dtype)
    out = _gqa_out(weights, v)
    y = torch.einsum("bshk,hkd->bsd", out, params.wo)
    if return_kv:
        return y, (k, v)
    return y


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_max, Hkv, hd)
    v: torch.Tensor  # (B, S_max, Hkv, hd)


def decode_attention(
    params,
    x,  # (B, 1, D) current token activations
    cache: KVCache,
    pos,  # (B,) int32 current position (number of tokens already cached)
    *,
    rope_theta: float,
    window: int,
):
    """One decode step: write this token's K/V into the cache at each
    row's ``pos`` (in place: the cache is preallocated), attend over it.

    The caller keeps ``pos < S_max`` (`decode.decode_step` checks it on the
    host); the reference's ``dynamic_update_slice`` would clamp instead.
    """
    b = x.shape[0]
    q, k_new, v_new = _project_qkv(params, x)
    q = L.apply_rope(q, pos[:, None], rope_theta)
    k_new = L.apply_rope(k_new, pos[:, None], rope_theta)

    rows = torch.arange(b, device=x.device)
    idx = pos.long()
    cache.k[rows, idx] = k_new[:, 0].to(cache.k.dtype)
    cache.v[rows, idx] = v_new[:, 0].to(cache.v.dtype)
    k, v = cache.k, cache.v

    s_max = k.shape[1]
    scale = 1.0 / np.sqrt(q.shape[-1])
    scores = _gqa_scores(q, k.to(q.dtype)).float() * scale
    ki = torch.arange(s_max, dtype=torch.int32, device=x.device)[None, None, None, None, :]
    qi = pos[:, None, None, None, None]
    mask = ki <= qi
    if window:
        mask = mask & (qi - ki < window)
    weights = _masked_softmax(scores, mask, x.dtype)
    out = _gqa_out(weights, v.to(x.dtype))
    y = torch.einsum("bshk,hkd->bsd", out, params.wo)
    return y, KVCache(k, v)


def cross_decode_attention(params, x, enc_k, enc_v, *, rope_theta):
    """Decode-time cross attention against precomputed encoder K/V."""
    q = torch.einsum("bsd,dhk->bshk", x, params.wq)
    if params.has_bias:
        q = q + params.bq
    scale = 1.0 / np.sqrt(q.shape[-1])
    scores = _gqa_scores(q, enc_k).float() * scale
    weights = torch.softmax(scores, dim=-1).to(x.dtype)
    out = _gqa_out(weights, enc_v)
    return torch.einsum("bshk,hkd->bsd", out, params.wo)


def precompute_cross_kv(params, enc_out):
    k = torch.einsum("bsd,dhk->bshk", enc_out, params.wk)
    v = torch.einsum("bsd,dhk->bshk", enc_out, params.wv)
    if params.has_bias:
        k = k + params.bk
        v = v + params.bv
    return k, v
