"""Training step: loss, gradients, optimizer update, optional gradient
compression hook (port of the JAX package's ``training/train_step.py``).

The parameters are the model's ``LM`` module; gradients, moments and
error-feedback residuals are dicts keyed by its parameter names. A step
updates the parameters in place.
"""

from __future__ import annotations

import dataclasses
import functools
from collections import defaultdict
from typing import NamedTuple, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.model import Model
from repro_torch.models.transformer import LM, reference_leaf
from repro_torch.training import optimizer as opt


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adamw: opt.AdamWConfig = opt.AdamWConfig()
    remat: bool = True
    z_loss: float = 1e-4
    aux_loss_weight: float = 0.01  # MoE load-balance
    grad_compression: str = "none"  # none | int8  (error-feedback int8)


class TrainState(NamedTuple):
    params: LM
    opt: opt.AdamWState
    ef: Optional[dict]  # error-feedback residuals (grad compression)


def init_state(model: Model, seed: int, tcfg: TrainConfig, device="cuda") -> TrainState:
    """Parameters drawn from ``seed`` on ``device`` (the GPU by default),
    zero moments, and zero residuals under int8 compression."""
    params = model.init(seed, device=resolve_device(device))
    named = dict(params.named_parameters())
    ef = None
    if tcfg.grad_compression == "int8":
        ef = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for n, p in named.items()}
    return TrainState(params=params, opt=opt.init(named), ef=ef)


def cross_entropy(logits, labels, z_loss: float = 0.0):
    """Token-mean CE with optional z-loss. labels < 0 are masked out.

    The gold logit is a ``gather`` where the reference contracts a one-hot
    (for a vocab-sharded reduction): both pick one exact value. Its
    backward scatters one value into each row of zeros, so it is exact
    whatever order the card adds in.
    """
    mask = (labels >= 0).float()
    labels = labels.clamp(min=0).long()
    lf = logits.float()
    if L.is_dtensor(lf):
        logz, gold = _sharded_logz_gold(lf, labels)
    else:
        logz = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, labels[..., None])[..., 0]
    ce = (logz - gold) * mask
    total = torch.clamp(mask.sum(), min=1.0)
    loss = ce.sum() / total
    if z_loss:
        loss = loss + z_loss * torch.sum((logz * mask) ** 2) / total
    return loss


def _sharded_logz_gold(lf, labels):
    """logsumexp and the gold logit of vocab-sharded DTensor logits, as a
    vocab-parallel loss computes them: the max and the sum of exponentials
    reduce over `model` as partial values (DTensor's own logsumexp would
    gather the whole vocabulary first), and the gold logit is gathered
    shard by shard and summed while it still has its last axis (DTensor
    cannot reduce the masked partial after that axis is dropped)."""
    L.SHARD_NOTES.add("cross-entropy: vocab-parallel logsumexp; the gold logit "
                      "reduced over model before its last axis is dropped")
    m = lf.detach().amax(dim=-1, keepdim=True)
    logz = (m + torch.log(torch.exp(lf - m).sum(dim=-1, keepdim=True)))[..., 0]
    gold = L.resolve_partial(torch.gather(lf, -1, labels[..., None]))[..., 0]
    return logz, gold


def loss_fn(params, batch, model: Model, tcfg: TrainConfig):
    logits, aux = model.forward(params, batch, remat=tcfg.remat)
    loss = cross_entropy(logits, batch["labels"], tcfg.z_loss)
    if model.cfg.n_experts:
        loss = loss + tcfg.aux_loss_weight * aux
    return loss, {"ce": loss, "aux": aux}


def value_and_grad(params: LM, batch, model: Model, tcfg: TrainConfig):
    """(loss, {"ce", "aux"}, {name: gradient}); a parameter the loss does
    not reach gets zeros, as ``jax.grad`` gives."""
    named = dict(params.named_parameters())
    loss, parts = loss_fn(params, batch, model, tcfg)
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), {k: v.detach() for k, v in parts.items()}, dict(zip(named, grads))


def _compress_int8(grads: dict, ef: dict):
    """Error-feedback int8 compression of the gradient all-reduce payload.

    Simulates: q = round(g+e / s) clipped to int8; residual e' = (g+e) - s*q.
    The scale s is one per reference leaf: the per-layer tensors of one
    stacked leaf (``blocks.*.attn.wq``) share the max over all of them, as
    the reference's (L, ...) leaf does. ``torch.round`` rounds half to
    even, as ``jnp.round`` does. Bitwise equal to the reference under jit.
    """
    groups = defaultdict(list)
    for name in grads:
        groups[reference_leaf(name)].append(name)
    out_g, out_e = {}, {}
    for names in groups.values():
        xs = [grads[n].float() + ef[n] for n in names]
        top = torch.stack([x.abs().amax() for x in xs]).amax()
        s = top / 127.0 + 1e-12
        for n, x in zip(names, xs):
            q = torch.clamp(torch.round(x / s), -127, 127)
            out_g[n] = (q * s).to(grads[n].dtype)
            # one rounding of x - q·s (exact in float64), as the reference's
            # jitted step computes it: XLA contracts it into a fused
            # multiply-add
            out_e[n] = (x.double() - q.double() * s.double()).float()
    return out_g, out_e


def train_step(state: TrainState, batch, model: Model, tcfg: TrainConfig):
    """(state, batch) → (state, metrics); the parameters and moments are
    updated in place."""
    loss, parts, grads = value_and_grad(state.params, batch, model, tcfg)
    ef = state.ef
    if tcfg.grad_compression == "int8":
        grads, ef = _compress_int8(grads, ef)
    named = dict(state.params.named_parameters())
    _, opt_state, om = opt.apply(tcfg.adamw, named, grads, state.opt)
    metrics = {"loss": loss, **parts, **om}
    return TrainState(params=state.params, opt=opt_state, ef=ef), metrics


def make_train_step(model: Model, tcfg: TrainConfig):
    return functools.partial(train_step, model=model, tcfg=tcfg)
