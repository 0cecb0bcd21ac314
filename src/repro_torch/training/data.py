"""Deterministic, shardable synthetic data pipeline (port of the JAX
package's ``training/data.py``).

Tokens are a pure function of (seed, step, position), threefry-hashed, so
any host can regenerate any step's batch without coordination: restart-safe,
skew-free and elastic. The hash is the reference's own: threefry2x32 with
``PRNGKey``, ``fold_in``, ``split`` and the partitionable ``random_bits``,
run on uint32 words emulated in int64 tensors, so the bits and the uniform
draws are the reference's exactly. A batch is drawn on the CPU, so it is
the same whatever the device, then copied to the device asked for (on the
GPU from pinned memory, so the copy does not wait for the card).

Tokens map a uniform u to ``(V + 1) ** u`` in float32 as the reference
does; the power is taken in float64 and rounded to float32 (torch's f32
``pow`` differs from XLA's in the last ulp often enough to move a token in
a few thousand at V = 151,936). The VLM patches and audio frames are
``sqrt(2)·erfinv(u)`` like the reference's normals; torch's ``erfinv``
differs from XLA's in the last ulps, so those agree within a tolerance.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator

import numpy as np
import torch

from repro_torch.models.config import ModelConfig

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    batch: int = 8
    seq: int = 128
    # multi-host slicing
    host_id: int = 0
    n_hosts: int = 1


# ---------------------------------------------------------------- threefry --
def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """The threefry2x32 block cipher (20 rounds) of the word pairs
    (x0, x1) under ``key`` (two words): uint32 values held in int64."""
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def _words(values) -> torch.Tensor:
    return torch.as_tensor(values, dtype=torch.int64)


def prng_key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the words (seed >> 32, seed & M32) of a
    32-bit seed, so (0, seed)."""
    return _words([0, seed & M32])


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: the key hashed with the count (0, data)."""
    y0, y1 = threefry2x32(key, _words([0]), _words([data & M32]))
    return torch.cat([y0, y1])


def _counters(n: int):
    """The (hi, lo) words of the 64-bit row-major iota over n elements."""
    i = torch.arange(n, dtype=torch.int64)
    return i >> 32, i & M32


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` with ``jax_threefry_partitionable``: key i is
    the hash of the counter i. (num, 2) words."""
    y0, y1 = threefry2x32(key, *_counters(num))
    return torch.stack([y0, y1], dim=1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits an element (partitionable): the two words of the
    element's counter hash, xor-ed. int64 in [0, 2^32)."""
    y0, y1 = threefry2x32(key, *_counters(math.prod(shape)))
    return (y0 ^ y1).reshape(shape)


def uniform(key: torch.Tensor, shape, minval: float = 0.0, maxval: float = 1.0):
    """``jax.random.uniform`` in float32: 23 random mantissa bits under the
    exponent of 1.0, minus 1, scaled to [minval, maxval)."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32)
    span = torch.tensor(maxval, dtype=torch.float32) - lo
    return torch.maximum(lo, floats * span + lo)


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal`` in float32: sqrt(2)·erfinv(u), u uniform on
    (-1, 1)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0)
    return torch.tensor(np.sqrt(2), dtype=torch.float32) * torch.erfinv(u)


# ------------------------------------------------------------------- batch --
def zipf_tokens(u: torch.Tensor, vocab: int) -> torch.Tensor:
    """Token ids ``clip(int((V + 1) ** u) - 1, 0, V - 1)`` of float32 draws u:
    the power in float64, rounded to float32 before the truncation."""
    base = float(np.float32(vocab + 1.0))
    powed = torch.pow(torch.tensor(base, dtype=torch.float64), u.double()).float()
    return torch.clamp(powed.to(torch.int32).long() - 1, 0, vocab - 1)


def synthetic_batch(cfg: ModelConfig, dcfg: DataConfig, step: int, device="cpu"):
    """Batch for one step. Same (seed, step) ⇒ same batch, forever.

    Tokens are Zipfian (inverse-CDF of a log-uniform draw), like natural
    text, not uniform: a uniform stream's next-token CE is irreducibly
    ln(V), so no optimizer-convergence test could ever observe progress.
    With a skewed marginal the model's CE drops toward the unigram entropy
    (≈ ln ln V nats lower) as soon as it learns the frequency bias.
    """
    key = fold_in(prng_key(dcfg.seed), step)
    ks = split(key, 4)
    b, s = dcfg.batch, dcfg.seq
    # (V+1)**u spans [1, V+1), so ids cover the full vocab [0, V-1]
    tokens = zipf_tokens(uniform(ks[0], (b, s)), cfg.vocab_size)
    # next-token LM objective: labels are tokens shifted left
    labels = torch.cat([tokens[:, 1:], torch.zeros((b, 1), dtype=tokens.dtype)], dim=1)
    batch = {"tokens": tokens, "labels": labels}
    if cfg.family == "vlm":
        batch["patches"] = normal(ks[1], (b, cfg.frontend_seq, cfg.d_model))
    if cfg.family == "audio":
        batch["frames"] = normal(ks[1], (b, cfg.encoder_seq, cfg.d_model))
    if dcfg.n_hosts > 1:
        lo = dcfg.host_id * b // dcfg.n_hosts
        hi = (dcfg.host_id + 1) * b // dcfg.n_hosts
        batch = {k: v[lo:hi] for k, v in batch.items()}
    device = torch.device(device)
    if device.type == "cuda":  # from pinned memory: no wait for the card's stream
        return {k: v.pin_memory().to(device, non_blocking=True) for k, v in batch.items()}
    return {k: v.to(device) for k, v in batch.items()}


def iterate(cfg: ModelConfig, dcfg: DataConfig, start_step: int = 0,
            device="cpu") -> Iterator:
    """Restartable iterator: resume from any checkpointed step."""
    step = start_step
    while True:
        yield step, synthetic_batch(cfg, dcfg, step, device)
        step += 1
