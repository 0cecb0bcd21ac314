"""Serving paths: prefill (build caches over a prompt) and single-token
decode steps, for every architecture family (port of the JAX package's
``models/decode.py``).

Cache layout (stacked on a leading layer axis, one slice a layer):
  attn families:  DecodeState.kv      (L, B, S_max, Hkv, hd) ×2
  ssm/hybrid:     DecodeState.ssm     (L, B, H, N, P) + conv history;
                  hybrid adds shared-attention KV per *application*
                  (n_apps, B, S_max, Hkv, hd) — Zamba2 shares weights
                  across applications but each application has its own KV.
  audio (enc-dec): self-KV per decoder layer + precomputed cross-K/V.

A decode step updates the preallocated caches in place (the new token's
K/V at ``pos``, each layer's SSM state and conv history) and returns the
state with ``pos`` advanced: a caller that needs a state again clones it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


class DecodeState(NamedTuple):
    kv_k: Optional[torch.Tensor] = None  # (L, B, S_max, Hkv, hd)
    kv_v: Optional[torch.Tensor] = None
    ssm_h: Optional[torch.Tensor] = None  # (L, B, H, N, P)
    ssm_conv: Optional[torch.Tensor] = None  # (L, B, W-1, C)
    shared_k: Optional[torch.Tensor] = None  # (n_apps, B, S_max, Hkv, hd)
    shared_v: Optional[torch.Tensor] = None
    cross_k: Optional[torch.Tensor] = None  # (L, B, T_enc, Hkv, hd)
    cross_v: Optional[torch.Tensor] = None
    pos: Optional[torch.Tensor] = None  # (B,) tokens cached so far
    # the same count kept on the host (every row holds as many), so the
    # cache bound is checked without reading the card
    length: int = 0
    s_max: int = 0


def n_attn_apps(cfg: ModelConfig) -> int:
    return sum(1 for k in cfg.layer_kinds() if k == "ssm_attn")


def init_decode_state(cfg: ModelConfig, batch: int, s_max: int,
                      device="cpu") -> DecodeState:
    """Empty caches on ``device``."""
    dt = cfg.cdtype
    hkv, hd = cfg.n_kv_heads, cfg.head_dim_ if cfg.n_heads else 0
    z = lambda *shape, dtype=dt: torch.zeros(shape, dtype=dtype, device=device)  # noqa: E731
    state = {}
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        state["kv_k"] = z(cfg.n_layers, batch, s_max, hkv, hd)
        state["kv_v"] = z(cfg.n_layers, batch, s_max, hkv, hd)
    if cfg.family in ("ssm", "hybrid"):
        conv_ch = cfg.d_inner + 2 * cfg.ssm_state
        state["ssm_h"] = z(cfg.n_layers, batch, cfg.ssm_heads, cfg.ssm_state,
                           cfg.ssm_head_dim, dtype=torch.float32)
        state["ssm_conv"] = z(cfg.n_layers, batch, cfg.ssm_conv_width - 1, conv_ch)
    if cfg.family == "hybrid":
        apps = n_attn_apps(cfg)
        state["shared_k"] = z(apps, batch, s_max, hkv, hd)
        state["shared_v"] = z(apps, batch, s_max, hkv, hd)
    if cfg.family == "audio":
        state["cross_k"] = z(cfg.n_layers, batch, cfg.encoder_seq, hkv, hd)
        state["cross_v"] = z(cfg.n_layers, batch, cfg.encoder_seq, hkv, hd)
    state["pos"] = z(batch, dtype=torch.int32)
    return DecodeState(**state, length=0, s_max=s_max)


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------
def prefill(params, batch, cfg: ModelConfig, s_max: int):
    """Run the prompt through the model, returning (last-token logits f32
    (B, 1, V), DecodeState with caches filled for positions [0, S))."""
    bsz = batch["tokens"].shape[0]
    x, enc_out = T.embed_inputs(params, batch, cfg)
    seq_len = x.shape[1]
    if seq_len > s_max:
        raise ValueError(f"prompt of {seq_len} positions exceeds s_max={s_max}")

    if cfg.family in ("ssm", "hybrid"):
        out, state = _prefill_ssm(params, x, cfg, s_max)
    else:
        out, state = _prefill_attn(params, x, cfg, s_max, enc_out)

    h = L.rmsnorm(params.final_norm, out[:, -1:, :], cfg.norm_eps)
    logits = T.logits_of(params, h, cfg)
    state = state._replace(
        pos=torch.full((bsz,), seq_len, dtype=torch.int32, device=x.device),
        length=seq_len, s_max=s_max)
    return logits.float(), state


def _pad_cache(kvs, s_max, dtype):
    """(L, B, S_max, Hkv, hd) zeros with each layer's (B, S, Hkv, hd) in
    [0, S); from DTensors, built on each rank's shards (batch over data,
    heads over model as attention left them)."""
    spec = A.head_spec(kvs[0].shape[2], kvs[0])
    return L.on_shards(lambda *kvs: _pad_local(kvs, s_max, dtype), (None,) + spec,
                       (spec,) * len(kvs), *kvs)


def _pad_local(kvs, s_max, dtype):
    b, s, hkv, hd = kvs[0].shape
    cache = torch.zeros((len(kvs), b, s_max, hkv, hd), dtype=dtype,
                        device=kvs[0].device)
    for i, kv in enumerate(kvs):
        cache[i, :, :s] = kv
    return cache


def _prefill_attn(params, x, cfg, s_max, enc_out):
    out = T._attn_stack(params, x, cfg, enc_out=enc_out, collect_kv=True)
    state_kwargs = dict(
        kv_k=_pad_cache([k for k, _ in out.kv], s_max, cfg.cdtype),
        kv_v=_pad_cache([v for _, v in out.kv], s_max, cfg.cdtype),
    )
    if cfg.family == "audio":
        cross = [A.precompute_cross_kv(bp.cross, enc_out) for bp in params.blocks]
        state_kwargs["cross_k"] = torch.stack([k for k, _ in cross]).to(cfg.cdtype)
        state_kwargs["cross_v"] = torch.stack([v for _, v in cross]).to(cfg.cdtype)
    return out.x, DecodeState(**state_kwargs)


def _prefill_ssm(params, x, cfg, s_max):
    """SSM/hybrid prefill: run per-layer blocks collecting final SSM states,
    the conv histories (the last W-1 *pre-conv* inputs, left-padded with
    zeros) and, for hybrid, each shared-attention application's KV."""
    w = cfg.ssm_conv_width
    h_fins, hists, kvs = [], [], []
    for bp, kind in zip(params.blocks, cfg.layer_kinds()):
        if kind == "ssm_attn":
            x, kv = T.shared_attn_block(params.shared_attn, x, cfg)
            kvs.append(kv)
        xn = L.rmsnorm(bp.ln1, x, cfg.norm_eps)
        proj = L.linear(xn, bp.ssm.in_proj)
        _, xin, b_mat, c_mat, _ = S._split_proj(
            proj, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads)
        conv_in = torch.cat([xin, b_mat, c_mat], dim=-1)
        hists.append(torch.nn.functional.pad(conv_in, (0, 0, w - 1, 0))[:, -(w - 1):, :])
        y, h_fin = S.ssm_block(bp.ssm, xn, cfg)
        h_fins.append(h_fin)
        x = x + y
    state_kwargs = dict(ssm_h=torch.stack(h_fins),
                        ssm_conv=torch.stack(hists).to(cfg.cdtype))
    if kvs:
        state_kwargs["shared_k"] = _pad_cache([k for k, _ in kvs], s_max, cfg.cdtype)
        state_kwargs["shared_v"] = _pad_cache([v for _, v in kvs], s_max, cfg.cdtype)
    return x, DecodeState(**state_kwargs)


# ---------------------------------------------------------------------------
# decode step
# ---------------------------------------------------------------------------
def decode_step(params, token, state: DecodeState, cfg: ModelConfig):
    """One token in, one token's logits out. token: (B,) int. Returns
    (logits f32 (B, V), the state advanced by one position)."""
    has_kv = state.kv_k is not None or state.shared_k is not None
    if has_kv and state.length >= state.s_max:
        raise ValueError(f"the caches are full: {state.length} of s_max="
                         f"{state.s_max} positions")
    x = L.embed(params.embed, token[:, None]).to(cfg.cdtype)

    if cfg.family in ("ssm", "hybrid"):
        x, state = _decode_ssm(params, x, state, cfg)
    else:
        x, state = _decode_attn(params, x, state, cfg)

    h = L.rmsnorm(params.final_norm, x, cfg.norm_eps)
    logits = T.logits_of(params, h, cfg)
    state = state._replace(pos=state.pos + 1, length=state.length + 1)
    return logits[:, 0].float(), state


def _decode_attn(params, x, state: DecodeState, cfg):
    is_cross = cfg.family == "audio"
    for i, (bp, window) in enumerate(zip(params.blocks, cfg.layer_windows())):
        h, _ = A.decode_attention(
            bp.attn,
            L.rmsnorm(bp.ln1, x, cfg.norm_eps),
            A.KVCache(state.kv_k[i], state.kv_v[i]),
            state.pos,
            rope_theta=cfg.rope_theta,
            window=window,
        )
        x = x + h
        if is_cross:
            x = x + A.cross_decode_attention(
                bp.cross,
                L.rmsnorm(bp.ln_cross, x, cfg.norm_eps),
                state.cross_k[i].to(x.dtype),
                state.cross_v[i].to(x.dtype),
                rope_theta=cfg.rope_theta,
            )
        y, _ = T.ffn(bp, L.rmsnorm(bp.ln2, x, cfg.norm_eps), cfg)
        x = x + y
    return x, state


def _decode_ssm(params, x, state: DecodeState, cfg):
    shared = getattr(params, "shared_attn", None)
    app = 0
    for i, (bp, kind) in enumerate(zip(params.blocks, cfg.layer_kinds())):
        if kind == "ssm_attn":
            h, _ = A.decode_attention(
                shared.attn,
                L.rmsnorm(shared.ln1, x, cfg.norm_eps),
                A.KVCache(state.shared_k[app], state.shared_v[app]),
                state.pos,
                rope_theta=cfg.rope_theta,
                window=0,
            )
            x = x + h
            x = x + L.mlp_apply(shared.mlp, L.rmsnorm(shared.ln2, x, cfg.norm_eps),
                                cfg.act)
            app += 1
        y, new = S.ssm_decode_step(
            bp.ssm,
            L.rmsnorm(bp.ln1, x, cfg.norm_eps),
            S.SSMState(h=state.ssm_h[i], conv=state.ssm_conv[i]),
            cfg,
        )
        state.ssm_h[i].copy_(new.h)
        state.ssm_conv[i].copy_(new.conv)
        x = x + y
    return x, state
