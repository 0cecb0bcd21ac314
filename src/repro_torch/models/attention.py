"""Attention blocks: GQA with RoPE, causal/sliding-window masks, cross
attention (encoder-decoder), and single-token decode against a KV cache
(port of the JAX package's ``models/attention.py``).

The window is a static Python int (0 = global/full attention): a stack of
mixed local and global layers (gemma3's 5:1 pattern) passes each layer its
own from ``ModelConfig.layer_windows()``.
"""

from __future__ import annotations

import functools
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


def head_spec(n_kv: int, like) -> tuple:
    """The (B, S, H, hd) spec attention's local core runs under on the
    DTensor ``like``'s mesh: batch over the data axes where it splits
    evenly, and heads over `model` where the kv heads divide it (each rank
    then holds whole query groups), else every head on every `model` rank
    (on plain tensors the spec is not read)."""
    if not L.is_dtensor(like):
        return (L.DP, None, None, None)
    sizes = dict(zip(like.device_mesh.mesh_dim_names, like.device_mesh.shape))
    heads = "model" if n_kv % sizes.get("model", 1) == 0 else None
    return (L.batch_axes(like.shape[0], like), None, heads, None)


def _note(spec) -> str:
    heads = "heads over model" if spec[2] else "every head on each model rank"
    return (f"attention (RoPE, scores, softmax, values): local_map on each rank's "
            f"shards, batch over data, {heads}")


def _model_spec(w, dims: int) -> tuple:
    """The spec of a DTensor weight's `model` sharding over its last
    ``dims`` dimensions (None where it is not sharded over `model`)."""
    lead = w.ndim - dims
    return tuple("model" if "model" in L.split_axes(w, lead + i) else None
                 for i in range(dims))


def proj_in(x, w):
    """(B, S, D) × (D, H, hd) → (B, S, H, hd). On DTensors a column-parallel
    product on each rank's shards: the weight keeps its `model` sharding
    (heads or head_dim), gathered over the data axes (DTensor's own einsum
    flattens a head_dim-sharded weight, which torch 2.11 refuses)."""
    if not L.is_dtensor(w):
        return torch.einsum("bsd,dhk->bshk", x, w)
    hk = _model_spec(w, 2)
    dp = L.batch_axes(x.shape[0], w)
    return L.on_shards(lambda x, w: torch.einsum("bsd,dhk->bshk", x, w),
                       (dp, None) + hk, ((dp, None, None), (None,) + hk), x, w,
                       note="attention projections: local_map on each rank's shards")


def proj_out(out, wo):
    """(B, S, H, hd) × (H, hd, D) → (B, S, D): on DTensors a row-parallel
    product on each rank's shards, its partial sums reduced over `model`."""
    if not L.is_dtensor(wo):
        return torch.einsum("bshk,hkd->bsd", out, wo)
    hk = _model_spec(wo, 3)[:2]
    dp = L.batch_axes(out.shape[0], wo)
    y = L.on_shards(lambda out, wo: torch.einsum("bshk,hkd->bsd", out, wo),
                    (dp, None, None), ((dp, None) + hk, hk + (None,)), out, wo,
                    partial=("model",) if any(hk) else ())
    return L.resolve_partial(y)


def _project_qkv(params, x, x_kv=None):
    x_kv = x if x_kv is None else x_kv
    q = proj_in(x, params.wq)
    k = proj_in(x_kv, params.wk)
    v = proj_in(x_kv, params.wv)
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
    s = x.shape[1]
    is_cross = x_kv is not None
    q, k, v = _project_qkv(params, x, x_kv)
    t = k.shape[1]
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :]

    def attend(q, k, v):
        """(out, the rotated keys)."""
        if not is_cross:
            q = L.apply_rope(q, positions, rope_theta)
            k = L.apply_rope(
                k, positions if kv_positions is None else kv_positions, rope_theta
            )
        b = q.shape[0]
        scale = 1.0 / np.sqrt(q.shape[-1])
        scores = _gqa_scores(q, k).float() * scale  # (B,G,R,S,T)

        qi = positions[:, None, None, :, None]  # (B,1,1,S,1)
        ki = (
            torch.arange(t, dtype=torch.int32, device=q.device)
            if kv_positions is None
            else kv_positions[0]
        )[None, None, None, None, :]
        mask = torch.ones((b, 1, 1, s, t), dtype=torch.bool, device=q.device)
        if causal and not is_cross:
            mask = mask & (ki <= qi)
            if window:
                mask = mask & (qi - ki < window)
        weights = _masked_softmax(scores, mask, x.dtype)
        return _gqa_out(weights, v), k

    spec = head_spec(k.shape[2], k)
    out, k = L.on_shards(attend, [spec, spec], (spec, spec, spec), q, k, v,
                         note=_note(spec))
    y = proj_out(out, params.wo)
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
    q, k_new, v_new = _project_qkv(params, x)

    def attend(q, k_new, v_new, k, v, pos):
        q = L.apply_rope(q, pos[:, None], rope_theta)
        k_new = L.apply_rope(k_new, pos[:, None], rope_theta)
        rows = torch.arange(q.shape[0], device=q.device)
        idx = pos.long()
        k[rows, idx] = k_new[:, 0].to(k.dtype)
        v[rows, idx] = v_new[:, 0].to(v.dtype)

        s_max = k.shape[1]
        scale = 1.0 / np.sqrt(q.shape[-1])
        scores = _gqa_scores(q, k.to(q.dtype)).float() * scale
        ki = torch.arange(s_max, dtype=torch.int32, device=q.device)[None, None, None, None, :]
        qi = pos[:, None, None, None, None]
        mask = ki <= qi
        if window:
            mask = mask & (qi - ki < window)
        weights = _masked_softmax(scores, mask, q.dtype)
        return _gqa_out(weights, v.to(q.dtype))

    spec = head_spec(cache.k.shape[2], cache.k)
    if L.is_dtensor(cache.k):
        # the write lands in the cache's own shards, so they must already be
        # where a spec puts them (a redistributed copy would lose it)
        from repro_torch.launch.sharding import placements

        mesh = cache.k.device_mesh
        by_seq = (None, "data", spec[2], None)
        if tuple(cache.k.placements) == placements(by_seq, mesh):
            out = L.on_shards(
                functools.partial(_attend_seq_shard, mesh=mesh, rope_theta=rope_theta,
                                  window=window),
                (None, None, spec[2], None),
                ((None, None, spec[2], None),) * 3 + (by_seq,) * 2 + ((None,),),
                q, k_new, v_new, cache.k, cache.v, pos, partial=("data",),
                note="decode attention over a sequence-sharded cache: each data "
                     "rank's positions (local_map), softmax combined over data")
            return proj_out(L.resolve_partial(out), params.wo), KVCache(cache.k, cache.v)
        if tuple(cache.k.placements) != placements(spec, mesh):
            raise NotImplementedError(
                f"decode into a cache placed {cache.k.placements}; the sharded "
                f"decode step writes a cache placed as {spec} or {by_seq}")
    out = L.on_shards(attend, spec, (spec,) * 5 + ((spec[0],),),
                      q, k_new, v_new, cache.k, cache.v, pos, note=_note(spec))
    y = proj_out(out, params.wo)
    return y, KVCache(cache.k, cache.v)


def _attend_seq_shard(q, k_new, v_new, k, v, pos, *, mesh, rope_theta, window):
    """One decode step on a data rank's slice of the cache's positions:
    the new K/V written where ``pos`` falls in this slice, scores over it,
    and the softmax's max and sum reduced over `data`. Returns this rank's
    share of the attention output (a partial sum over `data`)."""
    from torch.distributed import _functional_collectives as funcol

    group = mesh.get_group("data")
    q = L.apply_rope(q, pos[:, None], rope_theta)
    k_new = L.apply_rope(k_new, pos[:, None], rope_theta)
    s_loc = k.shape[1]
    off = mesh.get_local_rank("data") * s_loc
    rows = torch.arange(q.shape[0], device=q.device)
    idx = pos.long() - off
    inside = ((idx >= 0) & (idx < s_loc))[:, None, None]
    at = idx.clamp(0, s_loc - 1)
    k[rows, at] = torch.where(inside, k_new[:, 0].to(k.dtype), k[rows, at])
    v[rows, at] = torch.where(inside, v_new[:, 0].to(v.dtype), v[rows, at])

    scale = 1.0 / np.sqrt(q.shape[-1])
    scores = _gqa_scores(q, k.to(q.dtype)).float() * scale  # (B,G,R,1,S_loc)
    ki = (off + torch.arange(s_loc, device=q.device))[None, None, None, None, :]
    qi = pos[:, None, None, None, None]
    mask = ki <= qi
    if window:
        mask = mask & (qi - ki < window)
    scores = torch.where(mask, scores, -1e30)
    top = funcol.all_reduce(scores.amax(dim=-1, keepdim=True), "max", group)
    p = torch.exp(scores - top)
    total = funcol.all_reduce(p.sum(dim=-1, keepdim=True), "sum", group)
    return _gqa_out((p / total).to(q.dtype), v.to(q.dtype))


def cross_decode_attention(params, x, enc_k, enc_v, *, rope_theta):
    """Decode-time cross attention against precomputed encoder K/V."""
    q = proj_in(x, params.wq)
    if params.has_bias:
        q = q + params.bq

    def attend(q, enc_k, enc_v):
        scale = 1.0 / np.sqrt(q.shape[-1])
        scores = _gqa_scores(q, enc_k).float() * scale
        weights = torch.softmax(scores, dim=-1).to(x.dtype)
        return _gqa_out(weights, enc_v)

    spec = head_spec(enc_k.shape[2], enc_k)
    out = L.on_shards(attend, spec, (spec,) * 3, q, enc_k, enc_v, note=_note(spec))
    return proj_out(out, params.wo)


def precompute_cross_kv(params, enc_out):
    k = proj_in(enc_out, params.wk)
    v = proj_in(enc_out, params.wv)
    if params.has_bias:
        k = k + params.bk
        v = v + params.bv
    return k, v
