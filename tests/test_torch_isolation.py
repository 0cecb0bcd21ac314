"""The port stands alone: no JAX, nothing of the JAX package, and no
silent move to the CPU.

- every ``repro_torch`` module imports in a fresh interpreter where any
  import of ``jax`` or ``repro`` raises;
- no source file of the port (nor ``chip_smoke.py``) names them;
- the entry points default to CUDA and raise where it is missing;
- ``chip_smoke.py`` fails, printing no result, without a GPU and without
  the package beside it.
"""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"

_BLOCKER = r"""
import importlib.abc, pkgutil, sys

class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "repro"):
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, Blocker())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    __import__(name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
assert not leaked, leaked
print(len(names))
"""


def test_every_module_imports_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", _BLOCKER], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20  # every module of the slice


_FORBIDDEN = re.compile(r"^\s*(import|from)\s+jax\b|\bimport\s+jax\b|(?<![\w/])repro\.",
                        re.MULTILINE)


def test_sources_name_neither_jax_nor_reference():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    hits = [f"{f.relative_to(REPO)}: {m.group(0).strip()}"
            for f in files for m in _FORBIDDEN.finditer(f.read_text())]
    assert not hits, hits


def test_solve_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from repro_torch.core import ParaQAOAConfig, solve
    from repro_torch.core.graph import Graph

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = Graph.erdos_renyi(12, 0.3, seed=0)
    with pytest.raises(RuntimeError, match="is_available"):
        solve(g, ParaQAOAConfig(n_qubits=8))


@pytest.mark.parametrize("entry", ["dist_checks", "solve_distributed", "cli", "example"])
def test_data_axis_entry_points_default_to_cuda(monkeypatch, entry):
    """The self-checks, the solve on a data mesh, and the CLI and example
    with ``--mesh data=2 --merge striped`` raise where CUDA is missing."""
    from repro_torch.core import ParaQAOAConfig, _dist_checks, solve_distributed
    from repro_torch.core.graph import Graph
    from repro_torch.examples import solve_16k
    from repro_torch.launch import solve_maxcut

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--n", "20", "--qubits", "6", "--mesh", "data=2", "--merge", "striped"]
    run = {
        "dist_checks": lambda: _dist_checks.main(["solve_pool"]),
        "solve_distributed": lambda: solve_distributed(
            Graph.erdos_renyi(12, 0.3, seed=0), ParaQAOAConfig(n_qubits=6), "data=2"),
        "cli": lambda: solve_maxcut.run(argv),
        "example": lambda: solve_16k.main(argv),
    }[entry]
    with pytest.raises(RuntimeError, match="is_available"):
        run()


@pytest.mark.parametrize("entry", ["service", "local_backend", "mesh_backend",
                                   "serve_cli", "service_mesh_check"])
def test_service_entry_points_default_to_cuda(monkeypatch, entry):
    """The solve service, its backends, the serve CLI and the service
    self-check raise where CUDA is missing."""
    from repro_torch.core import _dist_checks
    from repro_torch.launch import serve_maxcut
    from repro_torch.service import ServiceConfig, SolveService, make_backend

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run = {
        "service": lambda: SolveService(ServiceConfig()),
        "local_backend": lambda: make_backend(),
        "mesh_backend": lambda: make_backend("data=4"),
        "serve_cli": lambda: serve_maxcut.run(["--requests", "2", "--n-min", "20",
                                               "--n-max", "30", "--qubits", "6"]),
        "service_mesh_check": lambda: _dist_checks.main(["service_mesh"]),
    }[entry]
    with pytest.raises(RuntimeError, match="is_available"):
        run()


def test_chip_smoke_fails_without_gpu_and_without_package(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    runs = [subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=120)]
    lone = tmp_path / "lone"
    lone.mkdir()
    shutil.copy(REPO / "chip_smoke.py", lone)
    runs.append(subprocess.run([sys.executable, "chip_smoke.py"], cwd=lone,
                               env=env, capture_output=True, text=True,
                               timeout=120))
    for proc in runs:
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout


@pytest.mark.parametrize("entry", ["train_cli", "init_state"])
def test_train_entry_points_default_to_cuda(monkeypatch, entry):
    """The training CLI without ``--device`` and ``init_state`` without a
    device raise where CUDA is missing."""
    from repro_torch import configs
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.training.train_step import TrainConfig, init_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run = {
        "train_cli": lambda: train.run(["--arch", "qwen1_5_0_5b", "--reduced",
                                        "--steps", "1"]),
        "init_state": lambda: init_state(build_model(configs.get_reduced("qwen1_5_0_5b")),
                                         0, TrainConfig()),
    }[entry]
    with pytest.raises(RuntimeError, match="is_available"):
        run()
