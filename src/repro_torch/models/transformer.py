"""Decoder stacks: dense/MoE transformers, SSM (Mamba2), hybrid (Zamba2),
and encoder-decoder (Whisper) assembly (port of the JAX package's
``models/transformer.py``).

Where the reference stacks per-layer parameters on a leading axis and
scans them, a stack here is an ``nn.ModuleList`` of per-layer modules run
by a Python loop. The heterogeneity the reference scans as data (gemma3's
local and global windows, Zamba2's periodic shared attention) becomes
plain Python over the static ``cfg.layer_windows()`` and
``cfg.layer_kinds()``; Zamba2's shared block is one module applied at every
``ssm_attn`` layer.

Rematerialisation is here: ``forward(..., remat=True)`` wraps each layer's
body in ``torch.utils.checkpoint`` under the policy ``set_remat_policy``
picks, with the reference's four names.

The dry-run's knobs: ``set_seq_parallel`` shards the residual stream's
sequence axis over `model` between blocks (a shard hint, a no-op on one
device); ``set_layer_unroll`` is accepted and recorded for the reference's
CLI, and changes nothing here: the reference unrolls its layer scan so
that XLA's cost analysis counts the body more than once, and a Python loop
over layers runs, and is counted, layer by layer already.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig


# the reference's layer stacks: one leading axis of per-layer leaves, which
# the port keeps as one tensor a layer under ``<stack>.<i>.``
STACKED = ("blocks", "enc_blocks")


def reference_leaf(name: str) -> str:
    """The reference's leaf of a port parameter name: ``blocks.3.attn.wq``
    is a slice of the stacked leaf ``blocks.attn.wq``; other names are
    their own leaf."""
    top, _, rest = name.partition(".")
    if top in STACKED:
        return f"{top}.{rest.partition('.')[2]}"
    return name


# ------------------------------------------------------------- dry-run knobs --
_LAYER_UNROLL = 1
_SEQ_PARALLEL = False  # shard the residual stream's seq axis over `model`


def set_layer_unroll(n: int) -> None:
    """Recorded only: a Python loop over layers has nothing to unroll."""
    global _LAYER_UNROLL
    _LAYER_UNROLL = max(1, int(n))


def set_seq_parallel(on: bool) -> None:
    global _SEQ_PARALLEL
    _SEQ_PARALLEL = bool(on)


def _residual_hint(x):
    """Megatron-style sequence parallelism: between blocks the residual
    stream is sharded over `model` on the sequence axis, so the all-reduce
    after a row-parallel product becomes a reduce-scatter and an
    all-gather."""
    if _SEQ_PARALLEL:
        return L.shard_hint(x, L.DP, "model", None)
    return L.shard_hint(x, L.DP, None, None)


# ------------------------------------------------------------------ remat --
_REMAT_POLICY = "batch_dots"  # batch_dots | dots | everything | off
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)


def set_remat_policy(name: str) -> None:
    global _REMAT_POLICY
    assert name in ("batch_dots", "dots", "everything", "off"), name
    _REMAT_POLICY = name


def _dot_batch(op, args) -> int:
    """The batch size of a product: 1 for mm, the leading dim of bmm's
    operands."""
    return args[0].shape[0] if op is torch.ops.aten.bmm.default else 1


def _save_dots(batched: bool, ctx, op, *args, **kwargs):
    """Selective-checkpoint policy: keep a product's output (every product,
    or with ``batched=False`` only those without a batch dimension, the
    reference's ``dots_with_no_batch_dims_saveable``), recompute the rest.

    ``torch.einsum`` lowers a product with no batch dimension
    (``bsd,dhk->bshk``) to ``bmm`` with a batch of 1, so the kind is told
    by the batch size, not by the op's name. A batched product whose batch
    dims all have size 1 counts as unbatched (B = 1 with one KV group)."""
    if op in _DOTS and (batched or _dot_batch(op, args) == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(body, remat: bool):
    """``body`` under the current policy: ``everything`` recomputes the
    whole layer in the backward pass, ``dots``/``batch_dots`` keep the
    products' outputs (selective activation checkpointing), ``off`` and
    ``remat=False`` (and a forward without autograd) run it as it is."""
    if not remat or _REMAT_POLICY == "off" or not torch.is_grad_enabled():
        return body
    kw = {}
    if _REMAT_POLICY != "everything":
        policy = functools.partial(_save_dots, _REMAT_POLICY == "dots")
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             policy)
    return lambda *args: checkpoint(body, *args, use_reentrant=False, **kw)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
class AttnBlock(nn.Module):
    """ln1 → attention, (ln_cross → cross attention), ln2 → MLP or MoE."""

    def __init__(self, cfg: ModelConfig, cross: bool = False, device=None):
        super().__init__()
        d, dt = cfg.d_model, cfg.pdtype
        self.ln1 = L.RMSNorm(d, dt, device)
        self.attn = A.Attention(d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_, dt,
                                bias=cfg.qkv_bias, device=device)
        self.ln2 = L.RMSNorm(d, dt, device)
        if cfg.n_experts:
            self.moe = M.MoE(d, cfg.d_ff, cfg.n_experts, dt,
                             dense_residual=cfg.moe_dense_residual,
                             f_dense=cfg.d_ff_dense, device=device)
        else:
            self.mlp = L.MLP(d, cfg.d_ff, cfg.act, dt, device)
        if cross:
            self.ln_cross = L.RMSNorm(d, dt, device)
            self.cross = A.Attention(d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_,
                                     dt, bias=cfg.qkv_bias, device=device)

    def reset(self, gen) -> None:
        for m in self.children():
            m.reset(gen)


class SSMBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, cfg.pdtype, device)
        self.ssm = S.SSM(cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_state,
                         cfg.ssm_conv_width, cfg.pdtype, device)

    def reset(self, gen) -> None:
        self.ln1.reset()
        self.ssm.reset(gen)


class LM(nn.Module):
    """Every family's parameters, under the reference's names: ``embed``,
    ``blocks`` (one module a layer), ``shared_attn`` (hybrid),
    ``enc_blocks`` and ``enc_norm`` (audio), ``final_norm``, ``unembed``
    (untied)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, dt = cfg.d_model, cfg.pdtype
        self.embed = L.Embedding(cfg.vocab_size, d, dt, device)
        if cfg.family in ("dense", "moe", "vlm"):
            self.blocks = nn.ModuleList(
                AttnBlock(cfg, device=device) for _ in range(cfg.n_layers))
        elif cfg.family in ("ssm", "hybrid"):
            self.blocks = nn.ModuleList(
                SSMBlock(cfg, device) for _ in range(cfg.n_layers))
            if cfg.family == "hybrid":
                # one full transformer block (attn + MLP), re-applied with the
                # *same weights* every attn_every layers — Zamba2's shared block
                self.shared_attn = AttnBlock(cfg, device=device)
        elif cfg.family == "audio":  # encoder-decoder
            self.enc_blocks = nn.ModuleList(
                AttnBlock(cfg, device=device) for _ in range(cfg.encoder_layers))
            self.enc_norm = L.RMSNorm(d, dt, device)
            self.blocks = nn.ModuleList(
                AttnBlock(cfg, cross=True, device=device) for _ in range(cfg.n_layers))
        else:
            raise ValueError(cfg.family)
        self.final_norm = L.RMSNorm(d, dt, device)
        if not cfg.tie_embeddings:
            self.unembed = L.Embedding(cfg.vocab_size, d, dt, device)

    def reset(self, gen) -> None:
        for m in self.children():
            if isinstance(m, nn.ModuleList):
                for blk in m:
                    blk.reset(gen)
            else:
                m.reset(gen)

    def unembed_table(self, cfg: ModelConfig) -> torch.Tensor:
        return self.embed.table if cfg.tie_embeddings else self.unembed.table


def init_params(gen: torch.Generator, cfg: ModelConfig) -> LM:
    """The model's parameters on ``gen.device``, drawn from ``gen``: weights
    N(0, 0.02²) (embeddings 0.01², the router 0.01², the conv 0.1²), norm
    scales 1, biases 0, and the SSM's a_log = log(1..H), dt_bias 0,
    d_skip 1, as the reference draws them."""
    params = LM(cfg, device=gen.device)
    params.reset(gen)
    return params


# ---------------------------------------------------------------------------
# forward passes (training / prefill)
# ---------------------------------------------------------------------------
class StackOut(NamedTuple):
    x: torch.Tensor
    aux_loss: torch.Tensor
    kv: Optional[list]  # a (k, v) pair of (B, S, Hkv, hd) a layer when collect_kv


def attn_block(bp, x, cfg: ModelConfig, *, window: int, positions=None,
               enc_out=None, return_kv: bool = False):
    """One transformer block; returns (x, aux, (k, v) or None)."""
    res = A.attention(
        bp.attn,
        L.rmsnorm(bp.ln1, x, cfg.norm_eps),
        rope_theta=cfg.rope_theta,
        window=window,
        causal=True,
        positions=positions,
        return_kv=return_kv,
    )
    h, kv = res if return_kv else (res, None)
    x = x + h
    if enc_out is not None:
        x = x + A.attention(
            bp.cross,
            L.rmsnorm(bp.ln_cross, x, cfg.norm_eps),
            rope_theta=cfg.rope_theta,
            window=0,
            causal=False,
            x_kv=enc_out,
        )
    y, aux = ffn(bp, L.rmsnorm(bp.ln2, x, cfg.norm_eps), cfg)
    return x + y, aux, kv


def ffn(bp, xn, cfg: ModelConfig):
    """The block's MLP or MoE: (y, aux loss or None)."""
    if cfg.n_experts:
        return M.moe_apply(
            bp.moe, xn, k=cfg.experts_per_token,
            capacity_factor=cfg.moe_capacity_factor,
            dense_residual=cfg.moe_dense_residual,
        )
    return L.mlp_apply(bp.mlp, xn, cfg.act), None


def _attn_stack(params, x, cfg: ModelConfig, *, enc_out=None, positions=None,
                collect_kv: bool = False, remat: bool = False):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    kvs = []
    for bp, window in zip(params.blocks, cfg.layer_windows()):
        body = functools.partial(attn_block, bp, cfg=cfg, window=window,
                                 positions=positions, enc_out=enc_out,
                                 return_kv=collect_kv)
        x, a, kv = _maybe_remat(body, remat and not collect_kv)(x)
        x = _residual_hint(x)
        if a is not None:
            aux = aux + a
        kvs.append(kv)
    return StackOut(x, aux, kvs if collect_kv else None)


def shared_attn_block(shared, x, cfg: ModelConfig, positions=None):
    """Zamba2's shared block (full attention + MLP): (x, (k, v))."""
    h, kv = A.attention(
        shared.attn,
        L.rmsnorm(shared.ln1, x, cfg.norm_eps),
        rope_theta=cfg.rope_theta,
        window=0,
        causal=True,
        positions=positions,
        return_kv=True,
    )
    x = x + h
    y = L.mlp_apply(shared.mlp, L.rmsnorm(shared.ln2, x, cfg.norm_eps), cfg.act)
    return x + y, kv


def _ssm_layer(bp, x, *, cfg: ModelConfig, shared=None, positions=None):
    """One Mamba2 layer, after Zamba2's shared block where ``shared`` is
    given: (x, the shared block's (k, v) or None)."""
    kv = None
    if shared is not None:
        x, kv = shared_attn_block(shared, x, cfg, positions)
    y, _ = S.ssm_block(bp.ssm, L.rmsnorm(bp.ln1, x, cfg.norm_eps), cfg)
    return x + y, kv


def _ssm_stack(params, x, cfg: ModelConfig, *, positions=None,
               collect_kv: bool = False, remat: bool = False):
    """Mamba2 / Zamba2 stack: at an ``ssm_attn`` layer the shared attention
    block runs before the SSM mixer. With ``collect_kv``, the (k, v) of
    each application of the shared block, in order."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    kvs = []
    for bp, kind in zip(params.blocks, cfg.layer_kinds()):
        shared = params.shared_attn if kind == "ssm_attn" else None
        body = functools.partial(_ssm_layer, bp, cfg=cfg, shared=shared,
                                 positions=positions)
        x, kv = _maybe_remat(body, remat and not collect_kv)(x)
        if kv is not None:
            kvs.append(kv)
    return StackOut(x, aux, kvs if collect_kv else None)


def encoder_forward(params, frames, cfg: ModelConfig):
    """Whisper-style encoder over precomputed (stub) frame embeddings."""
    x = frames
    for bp in params.enc_blocks:
        h = A.attention(
            bp.attn,
            L.rmsnorm(bp.ln1, x, cfg.norm_eps),
            rope_theta=cfg.rope_theta,
            window=0,
            causal=False,
        )
        x = x + h
        x = x + L.mlp_apply(bp.mlp, L.rmsnorm(bp.ln2, x, cfg.norm_eps), cfg.act)
    return L.rmsnorm(params.enc_norm, x, cfg.norm_eps)


def embed_inputs(params, batch, cfg: ModelConfig, hint: bool = False):
    """Token embeddings in the activation dtype, with a VLM's patches
    prepended, and an audio model's encoder output: (x, enc_out). ``hint``:
    the token embeddings are hinted to the batch axes, as the training
    forward does."""
    x = L.embed(params.embed, batch["tokens"]).to(cfg.cdtype)
    if hint:
        x = L.shard_hint(x, L.DP, None, None)
    enc_out = None
    if cfg.family == "vlm":
        x = torch.cat([batch["patches"].to(cfg.cdtype), x], dim=1)
    if cfg.family == "audio":
        enc_out = encoder_forward(params, batch["frames"].to(cfg.cdtype), cfg)
    return x, enc_out


def logits_of(params, h, cfg: ModelConfig):
    """(B, S, V) logits of the final-norm output, in the activation dtype.
    On DTensors a column-parallel product on each rank's shards (the
    vocabulary over `model` where the table is so placed): DTensor's own
    flattens a batch split over two mesh axes with the sequence, which it
    cannot propagate on the multi-pod mesh."""
    table = params.unembed_table(cfg)

    def product(h, table):
        return torch.matmul(h, table.to(h.dtype).t())

    if not L.is_dtensor(table):
        return product(h, table)
    vocab = "model" if "model" in L.split_axes(table, 0) else None
    dp = L.batch_axes(h.shape[0], table)
    return L.on_shards(product, (dp, None, vocab), ((dp, None, None), (vocab, None)), h, table,
                       note="logits: a column-parallel product on each rank's shards "
                            "(local_map)")


def forward(params, batch, cfg: ModelConfig, *, remat: bool = False):
    """Training forward: returns (logits, aux_loss). With ``remat``, each
    decoder layer is rematerialised under the policy of
    `set_remat_policy` (the encoder is not, as in the reference).

    batch: {"tokens": (B,S)} plus family extras:
      vlm:   {"patches": (B,P,D)} — prepended to the token embeddings
      audio: {"frames": (B,T,D)} — encoder input (stub conv frontend)
    """
    x, enc_out = embed_inputs(params, batch, cfg, hint=True)
    if cfg.family in ("ssm", "hybrid"):
        out = _ssm_stack(params, x, cfg, remat=remat)
    else:
        out = _attn_stack(params, x, cfg, enc_out=enc_out, remat=remat)

    h = L.rmsnorm(params.final_norm, out.x, cfg.norm_eps)
    if cfg.family == "vlm":  # only text positions produce logits
        h = h[:, batch["patches"].shape[1]:, :]
    logits = L.shard_hint(logits_of(params, h, cfg), L.DP, None, "model")
    return logits, out.aux_loss
