"""Mamba2 / SSD (state-space duality) block, chunked matmul form (port of
the JAX package's ``models/ssm.py``).

Implements the SSD algorithm of Dao & Gu 2024 (arXiv:2405.21060): the
sequence is processed in chunks of Q tokens; within a chunk the recurrence
is materialized as a (Q, Q) lower-triangular attention-like matmul, and
across chunks a Python loop carries the (H, N, P) state. The per-step
recurrence (for decode) and the chunked form are tested to agree.

Block structure follows Mamba2: in_proj → causal depthwise conv on
(x, B, C) → SSD → gated RMSNorm → out_proj. ``F.softplus`` returns x
above 20 where ``jax.nn.softplus`` returns x + log1p(e^-x): they differ by
at most e^-20 relative.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers as L


class SSM(nn.Module):
    def __init__(self, d_model: int, d_inner: int, n_heads: int, d_state: int,
                 conv_width: int, dtype, device=None):
        super().__init__()
        conv_ch = d_inner + 2 * d_state
        f32 = torch.float32
        # projects to [z, x, B, C, dt]
        self.in_proj = L.empty_param(
            (d_model, 2 * d_inner + 2 * d_state + n_heads), dtype, device)
        self.conv_w = L.empty_param((conv_width, conv_ch), dtype, device)
        self.conv_b = L.empty_param((conv_ch,), dtype, device)
        self.a_log = L.empty_param((n_heads,), f32, device)
        self.dt_bias = L.empty_param((n_heads,), f32, device)
        self.d_skip = L.empty_param((n_heads,), f32, device)
        self.norm = L.RMSNorm(d_inner, dtype, device)
        self.out_proj = L.empty_param((d_inner, d_model), dtype, device)

    def reset(self, gen) -> None:
        n_heads = self.a_log.shape[0]
        L.normal_(self.in_proj, gen)
        L.normal_(self.conv_w, gen, scale=0.1)
        L.normal_(self.out_proj, gen)
        L.fill_(self.conv_b, 0.0)
        with torch.no_grad():
            self.a_log.copy_(torch.log(torch.linspace(
                1.0, float(n_heads), n_heads, dtype=torch.float32)))
        L.fill_(self.dt_bias, 0.0)
        L.fill_(self.d_skip, 1.0)
        self.norm.reset()


def _split_proj(proj, d_inner, d_state, n_heads):
    z = proj[..., :d_inner]
    x = proj[..., d_inner : 2 * d_inner]
    b = proj[..., 2 * d_inner : 2 * d_inner + d_state]
    c = proj[..., 2 * d_inner + d_state : 2 * d_inner + 2 * d_state]
    dt = proj[..., 2 * d_inner + 2 * d_state :]
    return z, x, b, c, dt


def _causal_conv(x, w, b):
    """Depthwise causal conv: x (B,S,C), w (W,C) → (B,S,C)."""
    width = w.shape[0]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width):  # width is 4: unrolled taps
        out = out + pad[:, i : i + x.shape[1], :] * w[i]
    return out + b


def ssd_chunked(x, dt, a, b_mat, c_mat, chunk: int, h0=None):
    """Chunked SSD scan.

    x: (B,S,H,P) values; dt: (B,S,H) step sizes (post-softplus);
    a: (H,) negative decay rates; b_mat/c_mat: (B,S,N).
    Returns (y (B,S,H,P), h_final (B,H,N,P)).
    """
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    q = chunk
    s_pad = ((s + q - 1) // q) * q
    nc = s_pad // q

    def pad(t):
        if s_pad == s:
            return t
        widths = [0, 0] * (t.ndim - 2) + [0, s_pad - s]
        return F.pad(t, widths)

    # zero-dt padding is exact: decay = exp(a·0) = 1 and the update term
    # carries a dt factor, so padded steps leave the state untouched.
    xf = pad(x.float())
    dtf = pad(dt.float())
    bf = pad(b_mat.float())
    cf = pad(c_mat.float())

    # chunk views
    xc = xf.reshape(bsz, nc, q, h, p)
    dtc = dtf.reshape(bsz, nc, q, h)
    bc = bf.reshape(bsz, nc, q, n)
    cc = cf.reshape(bsz, nc, q, n)

    l = a[None, None, None, :] * dtc  # (B,nc,Q,H) log-decay per step
    lc = torch.cumsum(l, dim=2)  # inclusive cumulative log decay
    ltot = lc[:, :, -1:, :]  # (B,nc,1,H)

    # ---- intra-chunk (quadratic-in-Q matmul form) -------------------------
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)  # (B,nc,Q,Q)
    seg = lc[:, :, :, None, :] - lc[:, :, None, :, :]  # (B,nc,Qi,Qj,H)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    # mask *inside* the exp: for j > i the log-decay difference is positive
    # and can overflow f32; -1e9 underflows to exactly 0.
    seg = torch.where(tri[None, None, :, :, None], seg, -1e9)
    decay = torch.exp(seg)
    m = cb[:, :, :, :, None] * decay * dtc[:, :, None, :, :]  # (B,nc,Qi,Qj,H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", m, xc)

    # ---- chunk summaries and inter-chunk recurrence -------------------------
    w_sum = torch.exp(ltot - lc) * dtc  # (B,nc,Q,H)
    s_chunk = torch.einsum("bcjh,bcjn,bcjhp->bchnp", w_sum, bc, xc)  # (B,nc,H,N,P)
    g_chunk = torch.exp(ltot[:, :, 0, :])  # (B,nc,H) total chunk decay

    h_prev = (torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
              if h0 is None else h0)
    h_ins = []
    for c in range(nc):  # the state entering each chunk
        h_ins.append(h_prev)
        h_prev = g_chunk[:, c, :, None, None] * h_prev + s_chunk[:, c]
    h_ins = torch.stack(h_ins, dim=1)  # (B,nc,H,N,P)

    y_inter = torch.einsum("bcin,bchnp,bcih->bcihp", cc, h_ins, torch.exp(lc))
    y = (y_intra + y_inter).reshape(bsz, s_pad, h, p)[:, :s]
    return y.to(x.dtype), h_prev


def ssd_step(h, x_t, dt_t, a, b_t, c_t):
    """Single-token recurrence: h (B,H,N,P); x_t (B,H,P); dt_t (B,H);
    b_t/c_t (B,N). Returns (y_t (B,H,P), h')."""
    g = torch.exp(a[None, :] * dt_t)  # (B,H)
    upd = torch.einsum("bh,bn,bhp->bhnp", dt_t, b_t, x_t)
    h_new = g[:, :, None, None] * h + upd
    y = torch.einsum("bn,bhnp->bhp", c_t, h_new)
    return y, h_new


class SSMState(NamedTuple):
    h: torch.Tensor  # (B, H, N, P) float32
    conv: torch.Tensor  # (B, W-1, conv_channels) rolling conv inputs


def ssm_block(params, x, cfg, h0=None):
    """Full Mamba2 block over a sequence. x: (B,S,D) → ((B,S,D), h_final)."""
    d_inner, d_state, n_heads = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    p_head = cfg.ssm_head_dim
    proj = torch.matmul(x, params.in_proj)
    z, xin, b_mat, c_mat, dt = _split_proj(proj, d_inner, d_state, n_heads)

    conv_in = torch.cat([xin, b_mat, c_mat], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, params.conv_w, params.conv_b))
    xin = conv_out[..., :d_inner]
    b_mat = conv_out[..., d_inner : d_inner + d_state]
    c_mat = conv_out[..., d_inner + d_state :]

    dtp = F.softplus(dt.float() + params.dt_bias)
    a = -torch.exp(params.a_log)
    xh = xin.reshape(*xin.shape[:2], n_heads, p_head)
    y, h_fin = ssd_chunked(xh, dtp, a, b_mat, c_mat, cfg.ssm_chunk, h0)
    y = y + params.d_skip[None, None, :, None].to(y.dtype) * xh
    y = y.reshape(*x.shape[:2], d_inner)
    y = L.rmsnorm(params.norm, y * F.silu(z), cfg.norm_eps)
    return torch.matmul(y, params.out_proj), h_fin


def ssm_decode_step(params, x, state: SSMState, cfg):
    """One-token Mamba2 step. x: (B,1,D) → ((B,1,D), new state)."""
    d_inner, d_state, n_heads = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    p_head = cfg.ssm_head_dim
    proj = torch.matmul(x, params.in_proj)[:, 0]
    z, xin, b_mat, c_mat, dt = _split_proj(proj, d_inner, d_state, n_heads)

    conv_in = torch.cat([xin, b_mat, c_mat], dim=-1)  # (B,C)
    hist = torch.cat([state.conv, conv_in[:, None, :]], dim=1)  # (B,W,C)
    conv_out = torch.einsum("bwc,wc->bc", hist, params.conv_w) + params.conv_b
    conv_out = F.silu(conv_out)
    xin = conv_out[..., :d_inner]
    b_t = conv_out[..., d_inner : d_inner + d_state]
    c_t = conv_out[..., d_inner + d_state :]

    dtp = F.softplus(dt.float() + params.dt_bias)
    a = -torch.exp(params.a_log)
    xh = xin.reshape(-1, n_heads, p_head)
    y, h_new = ssd_step(state.h, xh, dtp, a, b_t, c_t)
    y = y + params.d_skip[None, :, None].to(y.dtype) * xh
    y = y.reshape(-1, 1, d_inner).to(x.dtype)  # f32 SSD state → act dtype
    y = L.rmsnorm(params.norm, y * F.silu(z)[:, None, :], cfg.norm_eps)
    out = torch.matmul(y, params.out_proj)
    return out.to(x.dtype), SSMState(h=h_new, conv=hist[:, 1:, :])
