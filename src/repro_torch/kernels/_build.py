"""Build and load the CUDA kernels: nvcc at first use, bound with ctypes.

Each ``csrc/<name>.cu`` compiles to its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds). All sources are
compiled together, one ``nvcc`` process each, into
``<checkout>/build/kernels/<hash>/``, where the hash covers every source
file and the compiler flags: an edited source gets a fresh directory, an
unchanged one is loaded as built. Nothing here runs at import time.

A source may export more than one entry point (``cutvals.cu`` has the
table pass, the full-range fill and the indexed form; ``cutbatch.cu`` the
split pass and the product; ``betagrad.cu`` the reads of one or two groups
and the final sum). Each wrapper bumps its op's count in
`launches` once per call that launches its kernels.

Each source built or loaded is a ``build`` event in the build ledger
(`obs.ledger`): its key the source hash, its duration the time from its
nvcc's start until the build was collected (the builds run in parallel)
plus the library's load, or the load alone where an earlier build left
the library.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from repro_torch.obs.clock import default_clock
from repro_torch.obs.ledger import get_ledger

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("betagrad", "cutbatch", "cutvals", "fused_layer", "mixer", "phase")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

P = ctypes.c_void_p
I64 = ctypes.c_int64
I32 = ctypes.c_int
# every entry point: (source it is built from, C function, C signature),
# pointers and the stream as void*, sizes as int64/int; each returns
# cudaGetLastError() after its launch
SIGNATURES = {
    "beta_grad_pass": ("betagrad", "pq_beta_grad_pass",
                       [P, P, P, P, P, I64, I32, I64, I32, I32, I32, I64, I64, I64,
                        I32, I32, I64, I64, I64, P]),
    "beta_grad_final": ("betagrad", "pq_beta_grad_final", [P, P, I64, I64, P]),
    "cut_batch_split": ("cutbatch", "pq_cut_batch_split",
                        [P, P, P, I64, I64, I64, P]),
    "cut_batch_dense": ("cutbatch", "pq_cut_batch_dense",
                        [P, P, P, P, P, P, P, I64, I64, I64, I64, I32, I32, P]),
    "cutvals": ("cutvals", "pq_cutvals", [P, P, P, I64, I32, I64, P]),
    "cutvals_tables": ("cutvals", "pq_cutvals_tables",
                       [P, P, P, P, I64, I64, I32, P]),
    "cutvals_at": ("cutvals", "pq_cutvals_at",
                   [P, P, P, P, I64, I64, I64, I32, I64, P]),
    "fused_layer": ("fused_layer", "pq_fused_phase_mixer",
                    [P, P, P, P, P, P, P, I64, I64, I32, I32, I64, P]),
    "mixer_trailing": ("fused_layer", "pq_mixer_trailing",
                       [P, P, P, P, P, I64, I64, I32, I64, P]),
    "mixer": ("mixer", "pq_mixer_strided",
              [P, P, P, P, P, I64, I64, I32, I64, I64, P]),
    "apply_phase": ("phase", "pq_apply_phase",
                    [P, P, P, P, P, P, I64, I64, I64, P]),
    "expectation": ("phase", "pq_expectation", [P, P, P, P, P, I64, I64, I64, P]),
    "phase_grad": ("phase", "pq_phase_grad",
                   [P, P, P, P, P, P, P, I64, I64, I64, P]),
}

_LIBS: dict[str, ctypes.CDLL] = {}

# kernel launches per wrapper name since the last `reset_launches`
launches: collections.Counter = collections.Counter()


def count_launch(name: str) -> None:
    launches[name] += 1


def reset_launches() -> None:
    launches.clear()


def add_launches(counts) -> None:
    """Count launches made outside a wrapper's call (a CUDA graph's replay
    of the launches `set_aside_launches` took out of its capture)."""
    launches.update(counts)


@contextlib.contextmanager
def set_aside_launches():
    """Yields a Counter that, when the block ends, holds the launches
    counted inside it; those are taken back out of `launches` (a capture
    into a CUDA graph launches nothing)."""
    before = collections.Counter(launches)
    taken = collections.Counter()
    try:
        yield taken
    finally:
        taken.update(launches)
        taken.subtract(before)
        taken += collections.Counter()  # keep what was counted inside
        launches.clear()
        launches.update(before)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile (if needed) and load every kernel library; idempotent."""
    if len(_LIBS) == len(SOURCES):
        return _LIBS
    key = source_hash()
    out_dir = BUILD_ROOT / key
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in SOURCES:
        so = out_dir / f"lib{name}.so"
        if so.exists():
            continue
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so, default_clock())
    failed = []
    build_s = {}
    for name, (proc, tmp, so, t0) in procs.items():
        log, _ = proc.communicate()
        build_s[name] = default_clock() - t0
        (out_dir / f"{name}.log").write_text(log)  # ptxas: registers, spills
        if proc.returncode != 0:
            failed.append(f"{name}.cu (rc {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    for name in SOURCES:
        t0 = default_clock()
        _LIBS[name] = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        get_ledger().note_build(name, key,
                                build_s.get(name, 0.0) + default_clock() - t0)
    for source, fn_name, argtypes in SIGNATURES.values():
        fn = getattr(_LIBS[source], fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return _LIBS


def ptxas_log(source: str) -> str:
    """nvcc's output for ``csrc/<source>.cu`` (``-Xptxas=-v``: each kernel's
    registers, shared memory and spill bytes) from the last build here."""
    path = BUILD_ROOT / source_hash() / f"{source}.log"
    return path.read_text() if path.exists() else ""


def entry(name: str):
    """The C entry point ``name`` of `SIGNATURES` (building on first use)."""
    source, fn_name, _ = SIGNATURES[name]
    return getattr(build_all()[source], fn_name)


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")


def require(t, name: str, dtype, shape: tuple, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what every kernel takes as given."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def on_cuda(t) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain path for device {t.device}")


def stream(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
