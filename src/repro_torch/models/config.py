"""Architecture configuration schema (port of the JAX package's
``models/config.py``: the same fields, defaults and methods).

One frozen dataclass describes every assigned architecture (LM-family
transformers, MoE, SSM/hybrid, encoder-decoder, VLM). ``repro_torch/configs/``
holds one instance per assigned arch; reduced variants power the CPU tests.
`cdtype` and `pdtype` are ``torch.dtype``s.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int  # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None  # default d_model // n_heads
    qkv_bias: bool = False  # qwen1.5 uses QKV bias
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    rope_theta: float = 10_000.0
    act: str = "silu"  # silu (SwiGLU) | gelu (plain MLP, whisper)

    # -- attention pattern ---------------------------------------------------
    sliding_window: Optional[int] = None  # window for local layers
    global_every: int = 0  # gemma3: every k-th layer is global (5:1 → k=6)

    # -- mixture of experts ----------------------------------------------------
    n_experts: int = 0
    experts_per_token: int = 0
    moe_dense_residual: bool = False  # arctic: dense FFN in parallel w/ MoE
    moe_capacity_factor: float = 1.25
    router_aux_loss: float = 0.01

    # -- state-space (Mamba2 / SSD) -------------------------------------------
    ssm_state: int = 0  # N (d_state)
    ssm_head_dim: int = 64  # P
    ssm_expand: int = 2  # d_inner = expand * d_model
    ssm_chunk: int = 64  # SSD chunk length
    ssm_conv_width: int = 4
    attn_every: int = 0  # zamba2: shared attention block every k layers

    # -- encoder-decoder (whisper) ---------------------------------------------
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500  # precomputed conv-frame count (stub frontend)

    # -- modality frontend stubs -------------------------------------------------
    frontend: Optional[str] = None  # vision_stub | audio_stub
    frontend_seq: int = 0  # patches / frames supplied by input_specs
    frontend_dim: int = 0  # stub embedding dim (== d_model)

    max_seq: int = 131_072
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    # ------------------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        assert self.n_heads > 0
        return self.d_model // self.n_heads

    @property
    def cdtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @property
    def pdtype(self) -> torch.dtype:
        return DTYPES[self.param_dtype]

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind: 'attn' | 'ssm' (decoder stack)."""
        if self.family == "ssm":
            return tuple("ssm" for _ in range(self.n_layers))
        if self.family == "hybrid":
            k = self.attn_every or 6
            return tuple(
                "ssm_attn" if (i % k == k - 1) else "ssm"
                for i in range(self.n_layers)
            )
        return tuple("attn" for _ in range(self.n_layers))

    def layer_windows(self) -> Tuple[int, ...]:
        """Per-layer attention window (0 = full/global attention)."""
        if self.sliding_window is None:
            return tuple(0 for _ in range(self.n_layers))
        k = self.global_every or 0
        return tuple(
            0 if (k and (i % k == k - 1)) else self.sliding_window
            for i in range(self.n_layers)
        )

    def n_params(self) -> int:
        """Analytic parameter count (for 6·N·D roofline bookkeeping)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim_ if self.n_heads else 0
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_attn = (
            d * self.n_heads * hd
            + 2 * d * self.n_kv_heads * hd
            + self.n_heads * hd * d
        ) if self.n_heads else 0
        if self.act == "silu":
            per_mlp = 3 * d * f
        else:
            per_mlp = 2 * d * f
        if self.n_experts:
            per_mlp = self.n_experts * (3 * d * f) + d * self.n_experts
            if self.moe_dense_residual:
                per_mlp += 3 * d * self.d_ff_dense
        per_ssm = (
            d * (2 * self.d_inner + 2 * self.ssm_state + self.ssm_heads)
            + self.d_inner * d
            + self.ssm_conv_width * (self.d_inner + 2 * self.ssm_state)
        )
        total = emb
        for kind in self.layer_kinds():
            if kind == "attn":
                total += per_attn + per_mlp + 2 * d
            elif kind == "ssm":
                total += per_ssm + 2 * d
            else:  # ssm_attn: ssm block + shared attn counted once below
                total += per_ssm + 2 * d
        if self.family == "hybrid":
            total += per_attn + 2 * d  # one shared attention block
        if self.is_encoder_decoder:
            # encoder layers + decoder cross-attention
            total += self.encoder_layers * (per_attn + per_mlp + 2 * d)
            total += self.n_layers * (per_attn + d)  # cross-attn per decoder layer
        return int(total)

    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if not self.n_experts:
            return self.n_params()
        d, f = self.d_model, self.d_ff
        dense_total = self.n_params()
        moe_all = self.n_layers * self.n_experts * 3 * d * f
        moe_active = self.n_layers * self.experts_per_token * 3 * d * f
        return int(dense_total - moe_all + moe_active)

    @property
    def d_ff_dense(self) -> int:
        """Arctic-style dense residual FFN width (when moe_dense_residual)."""
        return self.d_ff


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Tiny same-family variant for CPU smoke tests."""
    small = dict(
        n_layers=min(cfg.n_layers, 4 if cfg.family != "hybrid" else 6),
        d_model=128,
        n_heads=min(cfg.n_heads, 4) if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        head_dim=32 if cfg.n_heads else None,
        d_ff=256 if not cfg.n_experts else 64,
        vocab_size=512,
        n_experts=min(cfg.n_experts, 8) if cfg.n_experts else 0,
        experts_per_token=min(cfg.experts_per_token, 2)
        if cfg.experts_per_token
        else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else cfg.ssm_head_dim,
        ssm_chunk=8,
        sliding_window=16 if cfg.sliding_window else None,
        encoder_layers=min(cfg.encoder_layers, 2),
        encoder_seq=24 if cfg.is_encoder_decoder else cfg.encoder_seq,
        frontend_seq=16 if cfg.frontend else 0,
        frontend_dim=128 if cfg.frontend else 0,
        max_seq=256,
        dtype="float32",
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
