"""The port's LM sharding rules (``launch/sharding.py``, the DeviceMesh
helpers of ``launch/mesh.py``) and ``reshard_state`` over DTensor
placements, on the CPU.

What each comparison holds, and why:

- ``param_spec`` (with ``with_fsdp``) leaf by leaf against the JAX
  package's pure functions, through the port's parameter names
  (``transformer.reference_leaf``), for the ten archs at published widths,
  every ``STRATEGY`` value, FSDP on and off, on both production meshes:
  equal specs, the reference's without its stacked layer axis. The
  reference reads only the mesh's names and sizes, so an ``AbstractMesh``
  stands in for it, and a mapping for the port's;
- the leaves where the reference's FSDP would shard the stacked layer axis
  itself (which the port's per-layer tensors do not have) are listed, and
  every leaf's bytes a device are the reference's;
- ``batch_specs`` and ``decode_state_specs`` equal to the reference's for
  every cell;
- the sharded forward over 4 gloo ranks on (data=2, model=2) against the
  port's one-device forward, and the elastic re-mesh over 8 ranks, (2, 4)
  then (4, 2) from the sharded state then one device: within the
  reference's atol of 1e-5 (the reference's own sharded runs are red on
  this tree, ROADMAP §3 item 3, so the port's one-device forward is the
  anchor). Each rank has its own 120 s limit.
"""

import itertools
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.launch import sharding as jsh
from repro.launch import specs as jspecs
from repro.models.model import build_model as jbuild
from repro_torch import configs as tconfigs
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsh
from repro_torch.launch import specs as tspecs
from repro_torch.models.transformer import LM, STACKED, reference_leaf

REPO = Path(__file__).resolve().parents[1]
MESHES = {
    "single": ((16, 16), ("data", "model")),
    "multi": ((2, 16, 16), ("pod", "data", "model")),
}
STRATEGIES = list(itertools.product(("auto", "heads", "head_dim", "replicated"),
                                    ("expert", "expert_ff")))
ATOL = 1e-5  # the reference's re-mesh tolerance (tests/test_fault_tolerance.py)


def _meshes(which):
    shape, names = MESHES[which]
    return AbstractMesh(shape, names), dict(zip(names, shape))


_ABSTRACT = {}


def _reference_leaves(arch):
    """{"blocks/attn/wq": abstract leaf} of the reference's parameters
    (``jax.eval_shape``: nothing allocated)."""
    if arch not in _ABSTRACT:
        cfg = jconfigs.get_config(arch)
        tree = jax.eval_shape(jbuild(cfg).init, jax.random.PRNGKey(0))
        _ABSTRACT[arch] = {"/".join(jsh._key_str(k) for k in path): leaf
                           for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    return _ABSTRACT[arch]


def _port_shapes(arch):
    params = LM(tconfigs.get_config(arch), device=torch.device("meta"))
    return {n: p for n, p in params.named_parameters()}


def _reference_spec(arch, leaf_name, amesh, fsdp):
    cfg = jconfigs.get_config(arch)
    leaf = _reference_leaves(arch)[leaf_name]
    spec = jsh.param_spec(tuple(leaf_name.split("/")), leaf, cfg, amesh)
    if fsdp and int(np.prod(leaf.shape)) >= 1 << 20:
        spec = jsh.with_fsdp(spec, leaf.shape, amesh, jsh.compat.mesh_data_axes(amesh))
    return tuple(spec) + (None,) * (len(leaf.shape) - len(spec))


def _stacked(name):
    return name.partition(".")[0] in STACKED


@pytest.fixture
def strategies():
    yield
    jsh.set_strategy(attn="auto", moe="expert")
    tsh.set_strategy(attn="auto", moe="expert")


@pytest.mark.parametrize("which", sorted(MESHES))
def test_param_spec_matches_reference_leaf_by_leaf(which, strategies):
    amesh, smesh = _meshes(which)
    checked = 0
    for arch in tconfigs.lm_arch_ids():
        cfg = tconfigs.get_config(arch)
        shapes = _port_shapes(arch)
        for (attn, moe), fsdp in itertools.product(STRATEGIES, (False, True)):
            jsh.set_strategy(attn=attn, moe=moe)
            tsh.set_strategy(attn=attn, moe=moe)
            port = tsh.params_shardings(shapes, cfg, smesh, fsdp=fsdp)
            assert port.keys() == shapes.keys()
            for name, sharding in port.items():
                want = _reference_spec(arch, reference_leaf(name).replace(".", "/"),
                                       amesh, fsdp)
                if _stacked(name):
                    assert want[0] is None, (arch, name, want)  # see the next test
                    want = want[1:]
                assert sharding.spec == want, (arch, attn, moe, fsdp, name)
                checked += 1
    assert checked > 10_000


@pytest.mark.parametrize("which", sorted(MESHES))
def test_stacked_axis_leaves_and_bytes_a_device(which):
    """No leaf of the ten archs has the reference's FSDP pick its stacked
    layer axis on either production mesh (so the list is empty), and every
    leaf holds the reference's bytes a device."""
    amesh, smesh = _meshes(which)
    on_stack = []
    for arch in tconfigs.lm_arch_ids():
        cfg = tconfigs.get_config(arch)
        shapes = _port_shapes(arch)
        port = tsh.params_shardings(shapes, cfg, smesh, fsdp=True)
        for name, sharding in port.items():
            leaf = reference_leaf(name).replace(".", "/")
            want = _reference_spec(arch, leaf, amesh, fsdp=True)
            if _stacked(name) and want[0] is not None:
                on_stack.append((arch, name))
            ref_shape = _reference_leaves(arch)[leaf].shape
            ref_bytes = np.prod(ref_shape) / _ways(want, smesh)
            depth = tsh.stack_depth(name, cfg)
            assert depth == (ref_shape[0] if _stacked(name) else 1)
            port_bytes = depth * np.prod(shapes[name].shape) / _ways(sharding.spec, smesh)
            assert port_bytes == ref_bytes, (arch, name)
    assert on_stack == []


def _ways(spec, sizes):
    n = 1
    for s in spec:
        for a in (s if isinstance(s, tuple) else (s,)):
            n *= sizes[a] if a else 1
    return n


@pytest.mark.parametrize("which", sorted(MESHES))
def test_batch_and_decode_state_specs_match_reference(which):
    amesh, smesh = _meshes(which)
    for cell in tspecs.all_cells():
        if isinstance(cell, tspecs.SkipCell):
            continue
        jcfg = jconfigs.get_config(cell.arch)
        if cell.kind == "decode":
            want = jsh.decode_state_specs(jcfg, amesh, cell.batch)
            got = tsh.decode_state_specs(cell.cfg, smesh, cell.batch)
            for field in want._fields:
                assert getattr(got, field) == tuple(getattr(want, field)), (cell, field)
            assert tsh.token_spec(smesh, cell.batch) == (
                (jsh._dp(amesh),) if cell.batch >= 16 else (None,))
        else:
            want = jsh.batch_specs(jcfg, amesh, cell.kind)
            got = tsh.batch_specs(cell.cfg, smesh, cell.kind)
            assert got == {k: tuple(v) for k, v in want.items()}, cell


def test_mesh_helpers_and_placements():
    from torch.distributed.tensor import Replicate, Shard

    smesh = {"pod": 2, "data": 16, "model": 16}
    assert tmesh.data_axes(smesh) == ("pod", "data")
    assert tmesh.model_axis(smesh) == "model"
    assert tsh.placements((("pod", "data"), None, "model"), smesh) == (
        Shard(0), Shard(0), Shard(2))
    assert tsh.placements((None, None), smesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="names mesh axis 'data'"):
        tsh.placements((None, "model", "data", "data"), smesh)  # as NamedSharding refuses
    with pytest.raises(RuntimeError, match="no process group"):
        tmesh.make_test_mesh(2, 4)


# --------------------------------------------------- ranks over gloo --
_FORWARD_SCRIPT = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import configs
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import device_mesh
from repro_torch.models import layers as ML
from repro_torch.models.model import build_model
from repro_torch.training.fault_tolerance import reshard_state
from repro_torch.training.train_step import TrainConfig, value_and_grad

mode, out = sys.argv[1], sys.argv[2]
dist.init_process_group("gloo")
rank = dist.get_rank()
ML.configure_shard_hints(("data", "model"))
errs = {}


def forward(model, params, tokens, mesh):
    with torch.no_grad(), implicit_replication():
        spec = ("data", None) if tokens.shape[0] % mesh["data"].size() == 0 else (None, None)
        batch = {"tokens": SH.place(tokens, spec, mesh)}
        return model.forward(params, batch)[0].full_tensor()


if mode == "forward":
    mesh = device_mesh((2, 2), ("data", "model"), "cpu")
    for arch in ("qwen1_5_0_5b", "moonshot_v1_16b_a3b", "mamba2_1_3b"):
        cfg = configs.get_reduced(arch)
        model = build_model(cfg)
        params = model.init(0, device="cpu")
        tokens = torch.arange(4 * 16, dtype=torch.int32).reshape(4, 16) % cfg.vocab_size
        with torch.no_grad():
            want = model.forward(params, {"tokens": tokens})[0]
        batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
        tcfg = TrainConfig(remat=True)
        loss_want, _, grads_want = value_and_grad(params, batch, model, tcfg)
        reshard_state(params, SH.params_shardings(params, cfg, mesh, fsdp=True, fsdp_min_size=1))
        assert all(isinstance(p, DTensor) for p in params.parameters())
        errs[arch] = float((forward(model, params, tokens, mesh) - want).abs().max())
        with implicit_replication():  # the train step's loss and gradients, FSDP on
            loss, _, grads = value_and_grad(
                params, {k: SH.place(v, ("data", None), mesh) for k, v in batch.items()},
                model, tcfg)
        errs[arch + "_loss"] = abs(float(loss.full_tensor()) - float(loss_want))
        errs[arch + "_grads"] = max(float((g.full_tensor() - grads_want[n]).abs().max())
                                    for n, g in grads.items())
        if arch == "qwen1_5_0_5b":  # a batch of one decoding into a cache sharded by position
            reshard_state(params, "cpu")
            prompt, nxt = tokens[:1, :8], tokens[0, 8:9]
            with torch.no_grad():
                _, st = model.prefill(params, {"tokens": prompt}, s_max=16)
                want_step = model.decode_step(params, nxt, st)[0]
                reshard_state(params, SH.params_shardings(params, cfg, mesh))
                with implicit_replication():
                    _, st = model.prefill(params, {"tokens": SH.place(prompt, (None, None), mesh)},
                                          s_max=16)
                    ds = SH.decode_state_specs(cfg, mesh, 1)
                    st = reshard_state(st, {f: SH.Sharding(mesh, getattr(ds, f))
                                            for f in ("kv_k", "kv_v", "pos")})
                    assert st.kv_k.placements[0].is_shard(2)  # (L, B, S, ...): positions over data
                    got = model.decode_step(params, SH.place(nxt, (None,), mesh),
                                            st)[0].full_tensor()
            errs["qwen_decode_by_position"] = float((got - want_step).abs().max())
else:  # the elastic re-mesh: (2, 4), then (4, 2) from the sharded state, then one device
    cfg = configs.get_reduced("qwen1_5_0_5b")
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    # the reference's batch of 2, which data=4 does not split: it goes in
    # whole, as the reference's does, and the hints leave it so
    tokens = torch.arange(2 * 16, dtype=torch.int32).reshape(2, 16) % cfg.vocab_size
    kept = {n: p.detach().clone() for n, p in params.named_parameters()}
    with torch.no_grad():
        want = model.forward(params, {"tokens": tokens})[0]
    for shape in ((2, 4), (4, 2)):
        mesh = device_mesh(shape, ("data", "model"), "cpu")
        reshard_state(params, SH.params_shardings(params, cfg, mesh))
        errs["x".join(map(str, shape))] = float(
            (forward(model, params, tokens, mesh) - want).abs().max())
    reshard_state(params, "cpu")
    with torch.no_grad():
        errs["one"] = float((model.forward(params, {"tokens": tokens})[0] - want).abs().max())
    errs["params_equal"] = float(all(
        not isinstance(p, DTensor) and torch.equal(p, kept[n])
        for n, p in params.named_parameters()))
np.savez(f"{out}/rank{rank}.npz", **errs)
dist.barrier()
dist.destroy_process_group()
"""


def _run_ranks(tmp_path, mode: str, world: int) -> list:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), WORLD_SIZE=str(world),
               MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _FORWARD_SCRIPT, mode, str(tmp_path)],
                              env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:  # each rank's own limit: a hung collective fails here
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


def test_sharded_forward_over_gloo_equals_one_device(tmp_path):
    """Reduced qwen (dense GQA), moonshot (MoE) and mamba2 (SSD) placed by
    ``params_shardings`` on (data=2, model=2) over 4 gloo ranks: the
    forward, and with FSDP the train step's loss and every gradient (remat
    on); and qwen's
    decode step for a batch of one, its caches sharded by position over
    `data` as ``decode_state_specs`` places them (the long_500k layout)."""
    for errs in _run_ranks(tmp_path, "forward", 4):
        archs = ("qwen1_5_0_5b", "moonshot_v1_16b_a3b", "mamba2_1_3b")
        assert set(errs) == {*archs, *(a + "_loss" for a in archs),
                             *(a + "_grads" for a in archs), "qwen_decode_by_position"}
        for arch, err in errs.items():
            assert err <= ATOL, (arch, err)


def test_elastic_remesh_over_gloo(tmp_path):
    """The counterpart of ``tests/test_fault_tolerance.py``'s elastic
    re-mesh: (2, 4) → (4, 2) from the sharded state → one device, over 8
    gloo ranks; every parameter back on one device bitwise."""
    for errs in _run_ranks(tmp_path, "remesh", 8):
        assert errs["params_equal"] == 1.0
        for key in ("2x4", "4x2", "one"):
            assert errs[key] <= ATOL, (key, errs[key])
        assert errs["one"] == 0.0


def test_reshard_state_to_a_device_keeps_the_structure():
    """A mapping keyed by parameter names and a plain tensor go to the
    device; the optimizer's step stays where it is; host counts pass."""
    from repro_torch.training.fault_tolerance import reshard_state
    from repro_torch.training.optimizer import AdamWState

    step = torch.tensor(3, dtype=torch.int32)
    state = {"opt": AdamWState(step, {"a": torch.ones(2)}, {"a": torch.zeros(2)}),
             "n": 5, "x": torch.arange(3)}
    moved = reshard_state(state, "cpu")
    assert moved["opt"].step is step and moved["n"] == 5
    assert torch.equal(moved["opt"].mu["a"], torch.ones(2))
    assert torch.equal(moved["x"], torch.arange(3))


def test_specs_module_matches_reference_grid():
    """The same 40 cells, skip reasons included, as the reference's."""
    want = jspecs.all_cells()
    got = tspecs.all_cells()
    assert [(c.arch, c.shape, type(c).__name__) for c in got] == [
        (c.arch, c.shape, type(c).__name__) for c in want]
    for g, w in zip(got, want):
        if isinstance(w, jspecs.SkipCell):
            assert g.reason == w.reason
        else:
            assert (g.kind, g.seq, g.batch) == (w.kind, w.seq, w.batch)
