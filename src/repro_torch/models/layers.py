"""Primitive layers: norms, RoPE, initializers, MLPs (port of the JAX
package's ``models/layers.py``).

Each layer is a parameter holder (an ``nn.Module`` whose parameters carry
the reference's leaf names and tensor layouts, so every einsum string
carries over unchanged) plus a plain function ``apply(params, x, ...)``.
A module is built empty, on any device (``"meta"`` allocates nothing), and
filled by ``reset(gen)`` from an explicit ``torch.Generator``.

Activation shard hints (``configure_shard_hints``, ``shard_hint``) are
the reference's ``with_sharding_constraint`` calls: the launcher or the
dry-run names the mesh's axes once, and a hint then redistributes a
DTensor to the spec's placements on its own mesh. On a plain tensor, or
while unconfigured, a hint returns its input itself, so one-device runs
are unchanged.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


# ------------------------------------------------- activation shard hints --
# This is how the (B, S, V) logits are pinned to (dp, None, "model") instead
# of being replicated over the vocab axis.
_HINT_AXES: frozenset = frozenset()


def configure_shard_hints(axis_names) -> None:
    global _HINT_AXES
    _HINT_AXES = frozenset(axis_names or ())


def shard_hint(x, *spec):
    """``x`` redistributed to ``spec``'s placements on its mesh when it is a
    DTensor and hints are configured, else ``x`` itself. Tuple entries keep
    only the axes present in the configured names; a dimension its axes do
    not split evenly stays whole (GSPMD pads such a shard, DTensor's views
    refuse it)."""
    if not _HINT_AXES or not is_dtensor(x):
        return x
    from repro_torch.launch.sharding import placements

    sizes = dict(zip(x.device_mesh.mesh_dim_names, x.device_mesh.shape))
    parts = []
    for n, s in zip(x.shape, spec):
        axes = tuple(a for a in (s if isinstance(s, tuple) else (s,))
                     if a in _HINT_AXES and a in sizes)
        even = n % int(np.prod([sizes[a] for a in axes])) == 0
        parts.append(None if not axes or not even
                     else axes if isinstance(s, tuple) else axes[0])
    want = placements(tuple(parts), x.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def on_shards(fn, out_spec, in_specs, *args, note: str = "", partial=()):
    """``fn(*args)``; where an argument is a DTensor, ``fn`` runs on each
    rank's local shards instead (``local_map``): every DTensor argument is
    first redistributed to its entry of ``in_specs`` (an entry for a plain
    argument is ignored), and the output comes back as a DTensor placed as
    ``out_spec`` says (a list of specs: a tuple of outputs), as partial
    sums over the mesh axes named in ``partial``. Spec names not on the
    mesh count as None.

    For work DTensor cannot shard itself (no rule, a rule that fails under
    fake tensors or on torch 2.11, an in-place cache write). An input
    whole on a mesh axis over which an output is split gets its gradient
    as a partial sum there. On plain tensors nothing changes."""
    mesh = next((a.device_mesh for a in args if is_dtensor(a)), None)
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    if note:
        SHARD_NOTES.add(note)
    from repro_torch.launch.sharding import placements

    def place(spec):
        names = set(mesh.mesh_dim_names)
        keep = []
        for s in spec:
            if isinstance(s, tuple):
                s = tuple(a for a in s if a in names) or None
            keep.append(s if s is None or isinstance(s, tuple) or s in names else None)
        return placements(tuple(keep), mesh)

    def place_out(spec):
        return [Partial() if axis in partial else p
                for axis, p in zip(mesh.mesh_dim_names, place(spec))]

    in_pl = tuple(place(sp) if is_dtensor(a) else None for a, sp in zip(args, in_specs))
    many = isinstance(out_spec, list)
    outs = [place_out(sp) for sp in (out_spec if many else [out_spec])]
    split = [any(not o[d].is_replicate() for o in outs) for d in range(mesh.ndim)]
    grad_pl = tuple(None if pl is None else
                    tuple(Partial() if p.is_replicate() and split[d] else p
                          for d, p in enumerate(pl)) for pl in in_pl)
    return local_map(fn, out_placements=tuple(outs) if many else outs[0],
                     in_placements=in_pl, in_grad_placements=grad_pl,
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def split_axes(x, dim: int) -> tuple:
    """The mesh axes over which the DTensor ``x``'s dimension ``dim`` is
    split."""
    return tuple(name for name, p in zip(x.device_mesh.mesh_dim_names, x.placements)
                 if p.is_shard(dim))


def linear(x, w):
    """``x @ w`` for (B, S, K) activations and a (K, N) weight. On DTensors
    a Megatron product on each rank's shards, as the weight is split over
    `model`: column-parallel (N split: the output split alike),
    row-parallel (K split: partial sums reduced here) or whole; the
    weight's data-axis (FSDP) shards are gathered. DTensor's own flattens
    a batch split over two mesh axes with the sequence, which it cannot
    propagate on the multi-pod mesh."""
    if not is_dtensor(w):
        return torch.matmul(x, w)
    k = "model" if "model" in split_axes(w, 0) else None
    n = "model" if "model" in split_axes(w, 1) else None
    dp = batch_axes(x.shape[0], w)
    y = on_shards(torch.matmul, (dp, None, n), ((dp, None, k), (k, n)), x, w,
                  partial=("model",) if k else (),
                  note="dense products: column/row-parallel on each rank's shards "
                       "(local_map)")
    return resolve_partial(y)


def batch_axes(n: int, like) -> tuple | None:
    """``DP`` where a batch of ``n`` splits evenly over the data axes of the
    DTensor ``like``'s mesh, else None (the batch replicated): a local
    computation's batch spec."""
    sizes = dict(zip(like.device_mesh.mesh_dim_names, like.device_mesh.shape))
    ways = int(np.prod([sizes.get(a, 1) for a in DP]))
    return DP if n % ways == 0 else None


def resolve_partial(x):
    """A DTensor with each partial placement reduced (``Replicate`` there),
    its other placements kept; a plain tensor as it is. A row-parallel
    product's partial sums are reduced where they are made (Megatron's
    all-reduce), so the residual stream stays batch-sharded only and
    DTensor never merges a sharded sequence axis into a flattened
    product."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    want = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    return x if want == tuple(x.placements) else x.redistribute(x.device_mesh, want)


def is_dtensor(x) -> bool:
    """True for a ``torch.distributed.tensor.DTensor`` (a sharded run)."""
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


DP = ("pod", "data")  # batch-parallel axis group

# what the sharded path did where DTensor could not shard an op itself; the
# dry-run copies these into each cell's record
SHARD_NOTES: set = set()


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
    card's stream on every decode step. Made outside inference mode, so
    tables first built by a generate can be saved for a later backward."""
    with torch.inference_mode(False):
        freqs = torch.from_numpy(rope_frequencies(head_dim, theta)).to(device)
        sign = torch.ones(head_dim)
        sign[: head_dim // 2] = -1.0
        return freqs, sign.to(device)


def _tracing() -> bool:
    """True while a ``FakeTensorMode`` is active."""
    return torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S).

    The reference's rotate-half form by a roll with full-width cos/sin
    tables: out = x·cos + roll(x, hd/2)·[-1…, 1…]·sin."""
    hd = x.shape[-1]
    # under fake tensors (the dry-run) the tables are made afresh: a cached
    # table would be real inside the trace, or fake in a later real forward
    tables = _rope_tables.__wrapped__ if _tracing() else _rope_tables
    freqs, sign = tables(hd, float(theta), x.device)
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
        g = linear(x, params.w_gate)
        u = linear(x, params.w_up)
        return linear(F.silu(g) * u, params.w_down)
    h = linear(x, params.w_up) + params.b_up
    h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default is the tanh form
    return linear(h, params.w_down) + params.b_down


# ------------------------------------------------------------- embedding --
class Embedding(nn.Module):
    def __init__(self, vocab: int, d: int, dtype, device=None):
        super().__init__()
        self.table = empty_param((vocab, d), dtype, device)

    def reset(self, gen) -> None:
        normal_(self.table, gen, scale=0.01)


def embed(params, tokens):
    """Rows of the table. On a DTensor table, vocab-parallel: each `model`
    rank gathers the rows its shard of the vocabulary holds and zeros for
    the others, summed over `model` (DTensor has no rule for the gather
    ``table[tokens]``, and its masked ``F.embedding`` fails on some
    meshes). Adding zeros is exact: the same rows, bit for bit."""
    table = params.table
    if not is_dtensor(table):
        return table[tokens]
    mesh = table.device_mesh
    split = "model" in split_axes(table, 0)

    def lookup(table, tokens):
        v = table.shape[0]
        idx = tokens.long() - (mesh.get_local_rank("model") * v if split else 0)
        inside = (idx >= 0) & (idx < v)
        rows = table[idx.clamp(0, v - 1)]
        return torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype))

    dp = batch_axes(tokens.shape[0], table)
    out = on_shards(lookup, (dp, None, None), (("model" if split else None, None), (dp, None)),
                    table, tokens, partial=("model",) if split else (),
                    note="embed: vocab-parallel lookup on each rank's shards (local_map), "
                         "summed over model")
    return resolve_partial(out)


def unembed(params, x, tied_table=None):
    table = tied_table if tied_table is not None else params.table
    return torch.matmul(x, table.t())
