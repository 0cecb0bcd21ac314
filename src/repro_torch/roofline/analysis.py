"""Per-kernel roofline bound on the H100 (port of the kernel half of
``repro/roofline/analysis.py``: ``KERNEL_PEAKS``, ``kernel_bound_s``,
``achieved_fraction``).

The least time a card could take for one launch is the larger of the
operations over the card's peak rate for their type and the bytes the
launch must move (each input read once, each output written once) over
its memory rate. Two operation types occur: f32 on the CUDA cores (every
state kernel and the cut tables; no TF32) and bf16 products with f32
accumulation on the tensor cores (``cut_batch_dense``, unit
``"bf16_tensor"``). The rows are NVIDIA's data-sheet figures, dense, at
the full power limit; a card set below it runs slower, which is why every
measurement keeps the card's power limit beside it.

The dry-run's roofline (the reference's lines 77-240) is the second half:
three terms a (arch × shape × mesh) cell, in seconds, on the H100 SXM data
sheet (`DATA_SHEET`):

  compute    = FLOPs a device / 989e12       (bf16 dense, tensor cores)
  memory     = bytes a device / 3.35e12      (HBM3)
  collective = Σ_ops bytes·factor / 50e9     (one 400 Gb/s NDR port a GPU)

The link: an H100 node joins 8 GPUs by NVLink, and every axis of the
production meshes (16 or 32 places) spans nodes, so each collective's ring
crosses the inter-node fabric, whose share a GPU is one 400 Gb/s
InfiniBand NDR port (50 GB/s). The reference's TPU constants are not
carried over.

The reference reads these from XLA: ``cost_analysis`` of the partitioned
program (per device) and the collectives of its HLO text. The port traces
its eager program under fake tensors on a fake world instead
(`launch/dryrun.py`), with `CostCounter`, a dispatch mode that sees each
rank's *local* shards' ops (below DTensor's dispatch):
- FLOPs: ``FlopCounterMode``'s formulas (its ``flop_registry``), op by op;
- bytes: every aten op's operands and outputs, views and allocations
  excepted: the traffic of the eager program, which fuses nothing (XLA's
  count is of the fused program, so the port's is the larger);
- collectives: a tally of (op, result bytes, group size), which
  `collective_stats` prices with `parse_collectives`' ring factors.

``descanned_totals`` has no counterpart: it undoes XLA's count of a layer
scan's body once, and the port's Python loop over layers runs, and is
counted, layer by layer.
"""

from __future__ import annotations

import dataclasses
import functools
import sys
from typing import Optional

# card → (f32 FLOP/s on the CUDA cores, memory bytes/s)
KERNEL_PEAKS = {
    "H100 SXM": (67e12, 3.35e12),
    "H100 PCIe": (51e12, 2.0e12),
    "H100 NVL": (60e12, 3.9e12),
}
# card → bf16 FLOP/s on the tensor cores, dense (f32 accumulation)
TENSOR_BF16_PEAKS = {
    "H100 SXM": 989e12,
    "H100 PCIe": 756e12,
    "H100 NVL": 835e12,
}
DEFAULT_CARD = "H100 SXM"
UNITS = ("f32", "bf16_tensor")


def peaks_for(name: str):
    """(row key, (flop/s, bytes/s)) for a device name as CUDA reports it
    ("NVIDIA H100 80GB HBM3" is the SXM part)."""
    for key in ("H100 PCIe", "H100 NVL"):
        if all(w in name for w in key.split()):
            return key, KERNEL_PEAKS[key]
    return DEFAULT_CARD, KERNEL_PEAKS[DEFAULT_CARD]


def bound_terms(flops: float, bytes_accessed: float, card: str = DEFAULT_CARD,
                unit: str = "f32"):
    """(operation-limited s, byte-limited s) for one launch on ``card``,
    its operations of type ``unit`` (one of `UNITS`)."""
    key, (pf, pb) = peaks_for(card)
    if unit == "bf16_tensor":
        pf = TENSOR_BF16_PEAKS[key]
    elif unit != "f32":
        raise ValueError(f"unit {unit!r} not in {UNITS}")
    return flops / pf, bytes_accessed / pb


def kernel_bound_s(flops: float, bytes_accessed: float,
                   card: str = DEFAULT_CARD, unit: str = "f32") -> float:
    """Roofline lower bound for one launch on ``card``: max of the two."""
    return max(bound_terms(flops, bytes_accessed, card, unit))


def bound_by(flops: float, bytes_accessed: float, card: str = DEFAULT_CARD,
             unit: str = "f32") -> str:
    """Which term bounds the launch: ``"operations"`` or ``"bytes"``."""
    ops_s, bytes_s = bound_terms(flops, bytes_accessed, card, unit)
    return "bytes" if bytes_s >= ops_s else "operations"


def achieved_fraction(flops: float, bytes_accessed: float, seconds: float,
                      card: str = DEFAULT_CARD, unit: str = "f32") -> float:
    """bound / measured: 1.0 means the launch ran at the peak model."""
    if seconds <= 0.0:
        return 0.0
    return kernel_bound_s(flops, bytes_accessed, card, unit) / seconds


# ------------------------------------------------------------ the dry-run --
DATA_SHEET = "H100 SXM"
PEAK_FLOPS = TENSOR_BF16_PEAKS[DATA_SHEET]  # bf16 dense FLOP/s a GPU
HBM_BW = KERNEL_PEAKS[DATA_SHEET][1]  # B/s a GPU
LINK_BW = 50e9  # B/s a GPU: one 400 Gb/s NDR port (every mesh axis spans nodes)

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def collective_factor(op: str, g: int) -> float:
    """Ring bytes on the wire a device, per byte of the op's result, in a
    group of ``g`` (`parse_collectives`' factors)."""
    g = max(int(g), 2)
    if op == "all-reduce":
        return 2.0 * (g - 1) / g
    if op in ("all-gather", "reduce-scatter", "all-to-all"):
        return (g - 1) / g
    if op == "collective-permute":
        return 1.0
    raise ValueError(op)


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    bytes_by_op: dict
    wire_bytes: float  # factor-adjusted bytes on the wire per device


def collective_stats(tally) -> CollectiveStats:
    """The counterpart of the reference's ``parse_collectives``: stats of a
    tally of ``(op, result bytes, group size)``, ``op`` one of
    `COLLECTIVES` (what `CostCounter` records, in place of the HLO's
    collective lines)."""
    counts: dict = {}
    raw: dict = {}
    wire = 0.0
    for op, size, g in tally:
        counts[op] = counts.get(op, 0) + 1
        raw[op] = raw.get(op, 0) + size
        wire += size * collective_factor(op, g)
    return CollectiveStats(counts=counts, bytes_by_op=raw, wire_bytes=wire)


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_wire_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float
    useful_ratio: float  # MODEL_FLOPS / (FLOPs a device × chips)
    collectives: dict
    memory_analysis: Optional[str] = None
    peaks: dict = dataclasses.field(default_factory=lambda: {
        "data_sheet": DATA_SHEET, "flops_per_s": PEAK_FLOPS,
        "hbm_bytes_per_s": HBM_BW, "link_bytes_per_s": LINK_BW})

    def to_dict(self):
        return dataclasses.asdict(self)


def build_roofline(*, arch: str, shape: str, mesh_desc: str, chips: int,
                   cost: dict, model_flops: float,
                   stats: Optional[CollectiveStats] = None,
                   memory_analysis: Optional[str] = None) -> Roofline:
    """The three terms of one cell; ``cost`` holds ``"flops"`` and
    ``"bytes accessed"`` a device, ``stats`` its collectives."""
    stats = stats or CollectiveStats({}, {}, 0.0)
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    terms = {
        "compute": flops / PEAK_FLOPS,
        "memory": byts / HBM_BW,
        "collective": stats.wire_bytes / LINK_BW,
    }
    total_flops = flops * chips
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_desc, chips=chips,
        flops_per_device=flops, bytes_per_device=byts,
        collective_wire_bytes=stats.wire_bytes,
        compute_s=terms["compute"], memory_s=terms["memory"],
        collective_s=terms["collective"],
        bottleneck=max(terms, key=terms.get),
        model_flops=model_flops,
        useful_ratio=model_flops / total_flops if total_flops else 0.0,
        collectives={"counts": stats.counts, "bytes": stats.bytes_by_op},
        memory_analysis=memory_analysis,
    )


def model_flops_for_cell(cell, n_params_active: int) -> float:
    """6·N·D for train, 2·N·D for prefill, 2·N·B (+ attention KV read
    flops) for one decode step."""
    if cell.kind == "train":
        return 6.0 * n_params_active * cell.batch * cell.seq
    if cell.kind == "prefill":
        return 2.0 * n_params_active * cell.batch * cell.seq
    # decode: one token per request
    flops = 2.0 * n_params_active * cell.batch
    cfg = cell.cfg
    if cfg.n_heads:  # attention reads the KV cache: 2·2·S·H·hd per layer
        for w in cfg.layer_windows():
            s_eff = cell.seq if w == 0 else min(w, cell.seq)
            flops += 4.0 * cell.batch * s_eff * cfg.n_heads * cfg.head_dim_
    return flops


# ------------------------------------------------------- per-rank counter --
def _codes():
    """The code objects of the two DTensor internals `CostCounter` must
    tell apart: its shape propagation (which runs each op at the global
    shape to learn the output's metadata, not part of the rank's work) and
    the all-to-all that its CPU route performs as an all-gather and a
    chunk (gloo has none; NCCL runs the all-to-all)."""
    from torch.distributed.tensor import _collective_utils, _sharding_prop

    prop = _sharding_prop.ShardingPropagator._propagate_tensor_meta_non_cached
    return prop.__code__, _collective_utils.shard_dim_alltoall.__code__


def _inside(code, depth: int = 64) -> bool:
    f = sys._getframe(2)
    while f is not None and depth:
        if f.f_code is code:
            return True
        f, depth = f.f_back, depth - 1
    return False


def _nbytes(x) -> int:
    import torch

    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return 0


@functools.lru_cache(maxsize=None)
def _named_group_size(name: str) -> int:
    import torch.distributed as dist

    return dist.distributed_c10d._resolve_process_group(name).size()


def _group_size(group) -> int:
    """The size of a group given by name (the functional ops) or as the
    boxed ``ProcessGroup`` the c10d ops take."""
    import torch.distributed as dist

    if isinstance(group, str):
        return _named_group_size(group)
    return dist.ProcessGroup.unbox(group).size()


# op name → (kind, where its group is among the args)
_FUNCTIONAL = {
    "all_reduce": ("all-reduce", 2), "all_reduce_": ("all-reduce", 2),
    "all_gather_into_tensor": ("all-gather", 2),
    "all_gather_into_tensor_out": ("all-gather", 2),
    "reduce_scatter_tensor": ("reduce-scatter", 3),
    "all_to_all_single": ("all-to-all", 3),
    "shard_dim_alltoall": ("all-to-all", 3),
}
_C10D = {
    "allreduce_": "all-reduce", "_allgather_base_": "all-gather",
    "allgather_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "send": "collective-permute",
}
_FREE = ("empty", "empty_like", "empty_strided", "detach", "lift_fresh",
         "_local_scalar_dense", "wait_tensor")


class CostCounter:
    """Per-rank FLOPs, bytes and collectives of what runs under it (a
    context manager around a ``TorchDispatchMode``).

    An op on DTensors is passed on to DTensor (the mode returns
    ``NotImplemented``), which then runs the rank's local ops under the
    mode: those are what is counted, so a ``Shard(1)`` product over a
    16-way axis counts 1/16 of the dense FLOPs. Ops DTensor runs to
    propagate shapes at the global size are not counted."""

    def __init__(self):
        from torch.utils.flop_counter import FlopCounterMode

        self.flop_registry = FlopCounterMode(display=False).flop_registry
        self._prop, self._a2a = _codes()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.tally: list = []
        self._mode = None

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                return counter._dispatch(func, types, args, kwargs or {})

        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        mode, self._mode = self._mode, None
        return mode.__exit__(*exc)

    def stats(self) -> CollectiveStats:
        return collective_stats(self.tally)

    def _dispatch(self, func, types, args, kwargs):
        import torch
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _inside(self._prop):
            return out
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        if ns in ("_c10d_functional", "_dtensor") and name in _FUNCTIONAL:
            kind, at = _FUNCTIONAL[name]
            g = _group_size(args[at] if len(args) > at else kwargs["group_name"])
            if kind == "all-gather" and _inside(self._a2a):
                kind, size = "all-to-all", _nbytes(args[0])
            else:
                size = _nbytes(out)
            self.tally.append((kind, size, g))
            return out
        if ns == "c10d":
            if name in _C10D:
                pg = next(a for a in args if isinstance(a, torch.ScriptObject))
                self.tally.append((_C10D[name], _nbytes(args[0]), _group_size(pg)))
            return out
        if ns == "prim" or func.is_view or name in _FREE or ns == "_c10d_functional":
            return out
        self.ops += 1
        self.bytes += _nbytes(list(args)) + _nbytes(list(kwargs.values())) + _nbytes(out)
        packet = func._overloadpacket
        if packet in self.flop_registry:
            self.flops += int(self.flop_registry[packet](*args, **kwargs, out_val=out))
        return out
