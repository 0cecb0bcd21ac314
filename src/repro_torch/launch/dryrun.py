"""Multi-pod dry-run: trace every (architecture × input shape) cell on the
production meshes with nothing allocated (port of the JAX package's
``launch/dryrun.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --qaoa   # the paper's workload

Where the reference lowers and compiles each cell for 512 placeholder
devices, the port runs its own eager step on a fake world:
- **the world**: ``torch.distributed``'s fake process group (``FakeStore``,
  backend ``"fake"``) of ``prod(mesh)`` ranks; this process is rank 0, and
  every collective returns at once;
- **the tensors**: fake (``FakeTensorMode``), on device ``"cpu"``: shapes
  and dtypes, no storage. Parameters, optimizer moments, batches and
  decode caches are DTensors placed by `launch.sharding`; CUDA is never
  initialised (each record holds ``torch.cuda.is_initialized()``);
- **the step**: the train step with remat on, ``Model.prefill``, or
  ``Model.decode_step``, with the cell's config at
  ``param_dtype="bfloat16"`` as the reference lowers it;
- **the costs**, a device's: `roofline.analysis.CostCounter` counts the
  rank's local ops (FLOPs by ``FlopCounterMode``'s formulas, bytes of every
  aten op's operands and outputs, the collectives DTensor issues), and
  `build_roofline` prices them on the H100 data sheet.

Each run writes JSON records under ``results/dryrun_torch/`` with the keys
of the reference's ``Roofline.to_dict()`` plus the route, the counters and
``cuda_initialized`` (the reference's ``results/dryrun/`` is its own).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import numpy as np
import torch

from repro_torch.launch import sharding as SH
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_production_mesh, mesh_axes
from repro_torch.roofline import analysis as RA

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "../../../results/dryrun_torch")

COUNTERS = {
    "flops_counter": "FlopCounterMode",
    "bytes_counter": "aten operands+outputs, eager",
}
MEMORY_ANALYSIS = "none: an eager trace has no compiled memory plan"


def fake_world(size: int) -> None:
    """Make this process rank 0 of a fake world of ``size`` ranks (the
    default process group), replacing any earlier fake world."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)


def production_mesh(multi_pod: bool):
    fake_world(512 if multi_pod else 256)
    return make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def _mesh_desc(mesh) -> str:
    return "x".join(f"{k}={v}" for k, v in mesh_axes(mesh).items())


def _count_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _fake_like(spec: torch.Tensor) -> torch.Tensor:
    """A fake zero tensor of a meta stand-in's shape and dtype (call under
    ``FakeTensorMode``)."""
    return torch.zeros(spec.shape, dtype=spec.dtype)


def trace_cell(cell: SP.Cell, mesh, *, unroll: int = 1, cap_factor=None):
    """Trace one cell's step on ``mesh`` under fake tensors (the
    reference's ``lower_cell``). Returns (the `CostCounter` of the step,
    meta: ``param_bytes`` and the notes of what was done where DTensor
    could not shard an op itself)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import layers as ML
    from repro_torch.models import transformer as MT
    from repro_torch.models.model import build_model
    from repro_torch.training import optimizer as opt
    from repro_torch.training.fault_tolerance import reshard_state
    from repro_torch.training.train_step import TrainConfig, TrainState, train_step

    ML.configure_shard_hints(mesh.mesh_dim_names)
    MT.set_layer_unroll(unroll)
    overrides = {"param_dtype": "bfloat16"}
    if cap_factor:
        overrides["moe_capacity_factor"] = cap_factor
    cfg = dataclasses.replace(cell.cfg, **overrides)
    model = build_model(cfg)
    counter = RA.CostCounter()
    try:
        with FakeTensorMode(), implicit_replication():
            params = MT.LM(cfg, device="cpu")
            named = dict(params.named_parameters())
            param_bytes = _count_bytes(named.values())
            if cell.kind == "train":
                shard = SH.params_shardings(params, cfg, mesh, fsdp=True)
                reshard_state(params, shard)
                named = dict(params.named_parameters())
                # the host's step count: a numpy scalar, which the update
                # reads without a dispatch (a tensor cannot be read here)
                step = np.int32(0)
                moments = opt.init(named)
                state = TrainState(
                    params=params,
                    opt=reshard_state(opt.AdamWState(step, moments.mu, moments.nu), shard),
                    ef=None)
                b_spec = SH.batch_specs(cfg, mesh, "train")
                batch = {k: SH.place(_fake_like(v), b_spec[k], mesh)
                         for k, v in SP.input_specs(cell).items()}
                with counter:
                    train_step(state, batch, model, TrainConfig(remat=True))
            elif cell.kind == "prefill":
                serve_fsdp = param_bytes / mesh_axes(mesh)["model"] > 8e9
                reshard_state(params, SH.params_shardings(params, cfg, mesh, fsdp=serve_fsdp))
                b_spec = SH.batch_specs(cfg, mesh, "prefill")
                batch = {k: SH.place(_fake_like(v), b_spec[k], mesh)
                         for k, v in SP.input_specs(cell).items()}
                with counter, torch.no_grad():
                    model.prefill(params, batch, s_max=cell.seq)
            else:  # decode
                serve_fsdp = param_bytes / mesh_axes(mesh)["model"] > 8e9
                reshard_state(params, SH.params_shardings(params, cfg, mesh, fsdp=serve_fsdp))
                abstract = SP.decode_state_specs_abstract(cell)
                ds_spec = SH.decode_state_specs(cfg, mesh, cell.batch)
                state = abstract._replace(**{
                    f: _fake_like(t) for f, t in zip(abstract._fields, abstract)
                    if isinstance(t, torch.Tensor)})
                state = reshard_state(state, {f: SH.Sharding(mesh, getattr(ds_spec, f))
                                              for f in ds_spec._fields})
                token = SH.place(torch.zeros((cell.batch,), dtype=torch.int32),
                                 SH.token_spec(mesh, cell.batch), mesh)
                with counter, torch.no_grad():
                    model.decode_step(params, token, state)
    finally:
        ML.configure_shard_hints(())
        MT.set_layer_unroll(1)
    return counter, {"param_bytes": param_bytes, "notes": sorted(ML.SHARD_NOTES)}


def _record(rec: dict, roof: RA.Roofline, counter: RA.CostCounter, route: str) -> dict:
    rec.update(roof.to_dict())
    rec.update(route=route, **COUNTERS, ops_per_device=counter.ops,
               cuda_initialized=torch.cuda.is_initialized())
    return rec


def _save(rec: dict, fn: str, tag: str) -> None:
    os.makedirs(RESULTS_DIR, exist_ok=True)
    slim = {k: v for k, v in rec.items() if k != "traceback"}
    slim["tag"] = tag
    with open(os.path.join(RESULTS_DIR, fn), "w") as f:
        json.dump(slim, f, indent=1, default=str)


def run_cell(cell: SP.Cell, *, multi_pod: bool, save: bool = True, tag: str = "",
             cap_factor=None) -> dict:
    from repro_torch.models import layers as ML

    t0 = time.time()
    mesh = production_mesh(multi_pod)
    chips = int(np.prod(mesh.shape))
    rec = {"arch": cell.arch, "shape": cell.shape, "mesh": _mesh_desc(mesh),
           "chips": chips, "kind": cell.kind}
    ML.SHARD_NOTES.clear()
    try:
        counter, meta = trace_cell(cell, mesh, cap_factor=cap_factor)
        roof = RA.build_roofline(
            arch=cell.arch, shape=cell.shape, mesh_desc=rec["mesh"], chips=chips,
            cost={"flops": counter.flops, "bytes accessed": counter.bytes},
            stats=counter.stats(),
            model_flops=RA.model_flops_for_cell(cell, cell.cfg.n_active_params()),
            memory_analysis=MEMORY_ANALYSIS)
        _record(rec, roof, counter, "eager")
        rec["status"] = "ok"
        rec["compile_s"] = time.time() - t0  # the trace's seconds
        rec.update(meta)
        print(f"[dryrun] {cell.arch} × {cell.shape} × {rec['mesh']}: OK "
              f"({rec['compile_s']:.1f}s) bottleneck={roof.bottleneck} "
              f"compute={roof.compute_s:.4f}s memory={roof.memory_s:.4f}s "
              f"collective={roof.collective_s:.4f}s")
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        rec["traceback"] = traceback.format_exc()[-2000:]
        print(f"[dryrun] {cell.arch} × {cell.shape}: FAILED — {rec['error'][:500]}")
    if save:
        pod = "multipod" if multi_pod else "singlepod"
        suffix = f"__{tag}" if tag else ""
        _save(rec, f"{cell.arch}__{cell.shape}__{pod}{suffix}.json", tag)
    return rec


def per_rank_fraction() -> float:
    """The FLOPs `CostCounter` counts for a column-parallel product on the
    single-pod mesh, (64, 1024) @ (1024, 4096) with the weight ``Shard(1)``
    over `model` = 16, over the product's dense FLOPs: 1/16 when it sees
    each rank's local shards, 1 if it saw the global op."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    mesh = production_mesh(False)
    counter = RA.CostCounter()
    with FakeTensorMode():
        x = SH.place(torch.empty(64, 1024), (None, None), mesh)
        w = SH.place(torch.empty(1024, 4096), (None, "model"), mesh)
        with counter:
            torch.matmul(x, w)
    return counter.flops / (2 * 64 * 1024 * 4096)


QAOA_EDGES, QAOA_P = 2048, 3


def run_qaoa_dryrun(*, multi_pod: bool, save: bool = True,
                    schedule: str = "alternating", tag: str = "",
                    group: int = 7) -> dict:
    """Dry-run the paper's own workload on the production mesh: the
    sharded-statevector QAOA (26 + log2(16) qubits) over the mesh's
    `model` axis, one shard a rank of the fake world's model group.

    Under fake CPU tensors the engine takes its plain PyTorch route, not
    the CUDA kernels (they need real device pointers), so the bytes
    counted are the plain ops', more than the fused kernels move."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core import distributed as dist_mod
    from repro_torch.core.axis import ProcessGroupAxis

    t0 = time.time()
    mesh = production_mesh(multi_pod)
    chips = int(np.prod(mesh.shape))
    n = 26 + int(np.log2(mesh_axes(mesh)["model"]))  # 30 qubits on 16-way TP
    rec = {"arch": "paraqaoa", "shape": f"sharded_statevector_{n}q",
           "mesh": _mesh_desc(mesh), "chips": chips, "kind": "qaoa",
           "schedule": schedule}
    try:
        axis = ProcessGroupAxis(mesh.get_group("model"))
        counter = RA.CostCounter()
        with FakeTensorMode():
            edges = torch.zeros((QAOA_EDGES, 2), dtype=torch.int32)
            weights = torch.zeros((QAOA_EDGES,), dtype=torch.float32)
            gammas = torch.zeros((QAOA_P,), dtype=torch.float32)
            with counter:
                dist_mod.sharded_qaoa(edges, weights, n, gammas, gammas, axis,
                                      schedule=schedule, top_k=4, group=group)
        roof = RA.build_roofline(
            arch="paraqaoa", shape=rec["shape"], mesh_desc=rec["mesh"], chips=chips,
            cost={"flops": counter.flops, "bytes accessed": counter.bytes},
            stats=counter.stats(),
            # statevector "model flops": p layers × (mixer matmuls + phase)
            model_flops=QAOA_P * (2 ** n) * (2 * 128 + 8.0),
            memory_analysis=MEMORY_ANALYSIS)
        _record(rec, roof, counter, "plain")
        rec["status"] = "ok"
        rec["compile_s"] = time.time() - t0
        print(f"[dryrun] paraqaoa {n}q × {rec['mesh']} ({schedule}): OK "
              f"({rec['compile_s']:.1f}s) bottleneck={roof.bottleneck}")
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        rec["traceback"] = traceback.format_exc()[-2000:]
        print(f"[dryrun] paraqaoa: FAILED — {rec['error'][:500]}")
    if save:
        pod = "multipod" if multi_pod else "singlepod"
        suffix = f"__{tag}" if tag else ""
        _save(rec, f"paraqaoa__qaoa_{schedule}__{pod}{suffix}.json", tag)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SP.SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--qaoa", action="store_true")
    ap.add_argument("--multi-pod", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--attn-shard", default="auto",
                    choices=["auto", "heads", "head_dim", "replicated"])
    ap.add_argument("--moe-shard", default="expert", choices=["expert", "expert_ff"])
    ap.add_argument("--remat-policy", default="batch_dots",
                    choices=["batch_dots", "dots", "everything", "off"])
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--moe-cap-shard", action="store_true")
    ap.add_argument("--moe-cap-factor", type=float, default=None)
    ap.add_argument("--qaoa-group", type=int, default=7)
    ap.add_argument("--tag", default="", help="suffix for result files")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells whose result JSON already exists")
    args = ap.parse_args(argv)
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as MT

    SH.set_strategy(attn=args.attn_shard, moe=args.moe_shard)
    MT.set_remat_policy(args.remat_policy)
    MT.set_seq_parallel(args.seq_parallel)
    MOE.set_capacity_sharding(args.moe_cap_shard)

    pods = {"single": [False], "multi": [True], "both": [False, True]}[args.multi_pod]
    failures = 0
    if args.qaoa:
        for mp in pods:
            for schedule in ("faithful", "alternating"):
                rec = run_qaoa_dryrun(multi_pod=mp, schedule=schedule, tag=args.tag,
                                      group=args.qaoa_group)
                failures += rec["status"] != "ok"
        if failures:
            raise SystemExit(f"{failures} dry-run cells failed")
        return

    if args.all:
        cells = SP.all_cells()
    else:
        assert args.arch and args.shape, "--arch and --shape (or --all/--qaoa)"
        cells = [SP.get_cell(args.arch, args.shape)]

    for cell in cells:
        if isinstance(cell, SP.SkipCell):
            print(f"[dryrun] SKIP {cell.arch} × {cell.shape}: {cell.reason}")
            for mp in pods:
                pod = "multipod" if mp else "singlepod"
                _save({"arch": cell.arch, "shape": cell.shape, "status": "skipped",
                       "reason": cell.reason}, f"{cell.arch}__{cell.shape}__{pod}.json",
                      args.tag)
            continue
        for mp in pods:
            if args.resume:
                pod = "multipod" if mp else "singlepod"
                suffix = f"__{args.tag}" if args.tag else ""
                fn = os.path.join(RESULTS_DIR, f"{cell.arch}__{cell.shape}__{pod}{suffix}.json")
                if os.path.exists(fn):
                    with open(fn) as f:
                        if json.load(f).get("status") == "ok":
                            print(f"[dryrun] resume-skip {cell.arch} × {cell.shape} × {pod}")
                            continue
            rec = run_cell(cell, multi_pod=mp, tag=args.tag, cap_factor=args.moe_cap_factor)
            failures += rec["status"] != "ok"
    if failures:
        raise SystemExit(f"{failures} dry-run cells failed")


if __name__ == "__main__":
    main()
