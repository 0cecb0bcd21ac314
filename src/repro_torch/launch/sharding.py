"""Sharding rules: parameter name → spec → DTensor placements (port of the
JAX package's ``launch/sharding.py``).

Megatron-style tensor parallelism on the `model` axis, batch data
parallelism on `(pod, data)`:

  embeddings / unembedding   vocab on `model`
  attention q/o projections  head axis on `model` (falls back to head_dim
                             when the head count doesn't divide the axis,
                             e.g. gemma3-4b's 8 heads on a 16-way axis)
  attention k/v projections  kv-head axis when divisible, else replicated
  MLP up/gate ⊥ down         d_ff on `model` (column- then row-parallel)
  MoE experts                expert axis on `model` (expert parallelism)
  SSM in/out projections     d_inner on `model`
  norms / biases / scalars   replicated

A spec is a tuple with one entry a tensor dimension: None, an axis name,
or a tuple of axis names (the reference's ``PartitionSpec``). `placements`
turns it into DTensor placements on a ``DeviceMesh``: ``Shard(d)`` on each
mesh axis that dimension d names (in the mesh's order, so ``("pod",
"data")`` shards pod-major as the reference's does), ``Replicate()`` on the
others. The rules read only the mesh's axis names and sizes, so a mapping
``{name: size}`` stands in for a mesh wherever no tensor is placed.

The reference's layer stacks carry a leading ``(L, ...)`` axis that the
port's per-layer modules do not: a port spec is the reference's without
that leading None. Two rules read the stack all the same:
- the FSDP threshold ``fsdp_min_size`` compares the stacked leaf's size
  (L times the port's tensor), as the reference's does;
- where `with_fsdp` would pick the stacked axis itself (no other dimension
  is larger and divisible), the port cannot shard it and takes the best of
  the others, which keeps the reference's bytes a device whenever one is
  divisible (``tests/test_torch_sharding.py`` lists such leaves).

Optimizer moments follow their parameter's spec. Batch specs: tokens and
labels on `(pod+data, None)`; decode KV caches shard the *sequence* axis
across `data` when the batch is too small to shard (long_500k), else the
batch axis.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.launch.mesh import data_axes, mesh_axes
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import STACKED


# ---------------------------------------------------------------- strategy --
# The dry-run's --attn-shard/--moe-shard flags override these defaults.
STRATEGY = {
    # attention projections: auto (heads→head_dim fallback) | heads |
    # head_dim | replicated (no attention TP; MLP TP only)
    "attn": "auto",
    # moe experts: expert (E on model) | expert_ff (E on model, F on data)
    "moe": "expert",
}


def set_strategy(**kwargs):
    for k, v in kwargs.items():
        assert k in STRATEGY, k
        STRATEGY[k] = v


def _dp(mesh):
    axes = data_axes(mesh)
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def _div(n: int, mesh, axis: str = "model") -> bool:
    axes = mesh_axes(mesh)
    return axis in axes and n % axes[axis] == 0


def _keys(path) -> list:
    if isinstance(path, str):
        return path.split(".")
    return [str(k) for k in path]


def param_spec(path, leaf, cfg: ModelConfig, mesh) -> tuple:
    """The spec of one parameter. ``path`` is its name (``"blocks.3.attn.wq"``)
    or the name's keys; ``leaf`` anything with a ``shape`` (the port's
    per-layer tensor)."""
    keys = _keys(path)
    name = keys[-1]
    rank = len(leaf.shape)

    def spec(*tail):
        """Pad with leading Nones to the leaf's rank."""
        return (None,) * (rank - len(tail)) + tail

    # ---- embeddings ----------------------------------------------------
    if "embed" in keys or "unembed" in keys:
        if _div(cfg.vocab_size, mesh):
            return spec("model", None)
        return spec(None, None)

    # ---- attention -----------------------------------------------------
    if name in ("wq", "wo"):
        mode = STRATEGY["attn"]
        heads_ok = cfg.n_heads and _div(cfg.n_heads, mesh) and mode in ("auto", "heads")
        hd_ok = (cfg.n_heads and _div(cfg.head_dim_, mesh)
                 and mode in ("auto", "head_dim"))
        if name == "wq":  # (d, H, hd)
            if heads_ok:
                return spec(None, "model", None)
            if hd_ok:
                return spec(None, None, "model")
            return spec(None, None, None)
        # wo: (H, hd, d)
        if heads_ok:
            return spec("model", None, None)
        if hd_ok:
            return spec(None, "model", None)
        return spec(None, None, None)
    if name in ("wk", "wv"):  # (d, Hkv, hd)
        mode = STRATEGY["attn"]
        if cfg.n_kv_heads and _div(cfg.n_kv_heads, mesh) and mode in ("auto", "heads"):
            return spec(None, "model", None)
        if cfg.n_heads and _div(cfg.head_dim_, mesh) and mode in ("auto", "head_dim"):
            return spec(None, None, "model")
        return spec(None, None, None)
    if name in ("bq", "bk", "bv"):  # (H, hd)
        nh = cfg.n_heads if name == "bq" else cfg.n_kv_heads
        if nh and _div(nh, mesh):
            return spec("model", None)
        return spec(None, None)

    # ---- MoE -----------------------------------------------------------
    if name == "router":
        return spec(None, None)
    # expert weights live directly under "moe"; the arctic dense residual
    # lives under "moe"/"dense" and follows the dense-MLP rules below
    if "moe" in keys and "dense" not in keys and name in ("w_gate", "w_up", "w_down"):
        if _div(cfg.n_experts, mesh):
            if STRATEGY["moe"] == "expert_ff" and _div(cfg.d_ff, mesh, "data"):
                if name == "w_down":  # (E, F, D)
                    return spec("model", "data", None)
                return spec("model", None, "data")  # (E, D, F)
            return spec("model", None, None)  # expert parallelism
        return spec(None, None, None)

    # ---- dense MLP (incl. arctic dense residual, zamba2 shared block) ---
    d_ff = max(cfg.d_ff, 1)
    if name in ("w_gate", "w_up"):
        return spec(None, "model") if _div(d_ff, mesh) else spec(None, None)
    if name == "w_down":
        return spec("model", None) if _div(d_ff, mesh) else spec(None, None)
    if name == "b_up":
        return spec("model") if _div(d_ff, mesh) else spec(None)
    if name == "b_down":
        return spec(None)

    # ---- SSM -----------------------------------------------------------
    if name == "in_proj":  # (d, 2*di + 2*N + H): heterogeneous columns
        return spec(None, None)
    if name == "out_proj":  # (di, d)
        return spec("model", None) if _div(cfg.d_inner, mesh) else spec(None, None)

    # ---- norms, scalars, SSM vectors --------------------------------------
    return (None,) * rank


def with_fsdp(spec: tuple, shape, mesh, axes=("data",)) -> tuple:
    """ZeRO-3-style extension: additionally shard the largest still-
    unsharded, divisible dimension (the last of equals) over the data
    axes."""
    sizes = mesh_axes(mesh)
    parts = list(spec) + [None] * (len(shape) - len(spec))
    size = int(np.prod([sizes[a] for a in axes]))
    cands = [(shape[i], i) for i in range(len(shape))
             if parts[i] is None and shape[i] % size == 0 and shape[i] >= size]
    if not cands:
        return tuple(parts)
    _, best = max(cands)
    parts[best] = axes if len(axes) > 1 else axes[0]
    return tuple(parts)


def stack_depth(name: str, cfg: ModelConfig) -> int:
    """The reference's leading layer count of a port parameter's leaf: the
    layer count for ``blocks.*``/``enc_blocks.*``, else 1."""
    top = name.partition(".")[0]
    if top not in STACKED:
        return 1
    return cfg.encoder_layers if top == "enc_blocks" else cfg.n_layers


class Sharding(NamedTuple):
    """Where one tensor goes: a mesh and a spec (the reference's
    ``NamedSharding``)."""
    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one a mesh axis."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for axis in mesh_axes(mesh):
        dims = [d for d, s in enumerate(spec)
                if s == axis or (isinstance(s, tuple) and axis in s)]
        if len(dims) > 1:  # as the reference's NamedSharding refuses it
            raise ValueError(f"spec {spec} names mesh axis {axis!r} on dims {dims}")
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def place(x, spec: tuple, mesh):
    """``x`` distributed over ``mesh`` as ``spec`` says."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(x, mesh, placements(spec, mesh))


def _named(tensors):
    if hasattr(tensors, "named_parameters"):
        return dict(tensors.named_parameters())
    return dict(tensors)


def params_shardings(params, cfg: ModelConfig, mesh, fsdp: bool = False,
                     fsdp_min_size: int = 1 << 20) -> dict:
    """``{name: Sharding}`` of every parameter of ``params`` (the model's
    ``LM`` module, or a mapping of names to anything with a ``shape``:
    optimizer moments, `Model.param_shapes`-like records). ``fsdp=True``:
    train-style ZeRO-3 sharding over the data axes of each leaf whose
    stacked size reaches ``fsdp_min_size``."""
    axes = data_axes(mesh)
    out = {}
    for name, leaf in _named(params).items():
        shape = tuple(leaf.shape)
        spec = param_spec(name, leaf, cfg, mesh)
        if fsdp and stack_depth(name, cfg) * int(np.prod(shape)) >= fsdp_min_size:
            spec = with_fsdp(spec, shape, mesh, axes)
        out[name] = Sharding(mesh, spec)
    return out


def batch_specs(cfg: ModelConfig, mesh, kind: str) -> dict:
    """Specs for the data batch of a given shape kind."""
    dp = _dp(mesh)
    if kind not in ("train", "prefill"):
        raise ValueError(kind)
    specs = {"tokens": (dp, None)}
    if kind == "train":
        specs["labels"] = (dp, None)
    if cfg.family == "vlm":
        specs["patches"] = (dp, None, None)
    if cfg.family == "audio":
        specs["frames"] = (dp, None, None)
    return specs


def decode_state_specs(cfg: ModelConfig, mesh, batch: int):
    """Specs for `DecodeState`'s tensors. Batch axis when it divides the dp
    axes; otherwise sequence-parallel over `data` (long-context
    single-request)."""
    from repro_torch.models.decode import DecodeState

    sizes = mesh_axes(mesh)
    dp = _dp(mesh)
    dp_size = int(np.prod([sizes[a] for a in (dp if isinstance(dp, tuple) else (dp,)) if a]))
    shard_batch = batch % max(dp_size, 1) == 0 and batch >= dp_size
    b_ax = dp if shard_batch else None
    s_ax = None if shard_batch else "data"
    kv_head_ax = "model" if _div(cfg.n_kv_heads or 1, mesh) else None
    kv = (None, b_ax, s_ax, kv_head_ax, None)
    ssm_head_ax = "model" if _div(cfg.ssm_heads, mesh) and cfg.ssm_state else None
    return DecodeState(
        kv_k=kv, kv_v=kv,
        ssm_h=(None, b_ax, ssm_head_ax, None, None),
        ssm_conv=(None, b_ax, None, None),
        shared_k=kv, shared_v=kv, cross_k=kv, cross_v=kv,
        pos=(b_ax,),
    )


def token_spec(mesh, batch: int) -> tuple:
    """A decode step's (B,) tokens: over the dp axes from 16 requests up,
    else replicated (the reference's dry-run rule)."""
    return (_dp(mesh),) if batch >= 16 else (None,)
