"""The ``--mesh`` CLI spec and the meshes it builds (the port of
``repro/launch/mesh.py``; the parser is a copy of its lines 26-75).

A spec is a comma-separated ``axis=size`` list, e.g. ``data=4`` or
``data=2,model=4``. Axis names are restricted to the runtime's three roles
(`pod`/`data`/`model`) and normalized to that order; `model` must be a
power of two (the sharded statevector's qubit swap rotates log2(model)
qubits). Parsing is pure string processing; `build_mesh` turns a parsed
spec into a `core.axis.Mesh`.

The LM sharding rules place tensors on a
``torch.distributed.device_mesh.DeviceMesh`` instead:
`make_production_mesh` and `make_test_mesh` build one over the current
world (``torch.distributed`` must be initialised with as many ranks as the
mesh has places: NCCL or gloo ranks, or the dry-run's fake world), and
`data_axes`/`model_axis` read a mesh's roles. `mesh_axes` gives
``{name: size}`` of a `DeviceMesh` or of a plain mapping that stands in
for one (the sharding rules read only the names and sizes).
"""

from __future__ import annotations

#: Canonical mesh axis order, outermost first.
AXIS_ORDER = ("pod", "data", "model")


def parse_mesh_spec(spec: str) -> dict:
    """Parse ``"data=2,model=4"`` into ``{"data": 2, "model": 4}``.

    Raises ValueError on malformed specs: unknown/duplicate axis names,
    missing ``=``, non-integer or non-positive sizes, a non-power-of-two
    `model` axis, or an empty spec.
    """
    if not isinstance(spec, str) or not spec.strip():
        raise ValueError(f"empty mesh spec: {spec!r} (expected e.g. 'data=2,model=4')")
    axes: dict = {}
    for item in spec.split(","):
        item = item.strip()
        if "=" not in item:
            raise ValueError(
                f"malformed mesh spec entry {item!r}: expected 'axis=size'")
        name, _, size_s = item.partition("=")
        name = name.strip()
        if name not in AXIS_ORDER:
            raise ValueError(
                f"unknown mesh axis {name!r}: expected one of {AXIS_ORDER}")
        if name in axes:
            raise ValueError(f"duplicate mesh axis {name!r} in {spec!r}")
        try:
            size = int(size_s)
        except ValueError:
            raise ValueError(
                f"mesh axis size must be an integer: {item!r}") from None
        if size < 1:
            raise ValueError(f"mesh axis size must be >= 1: {item!r}")
        axes[name] = size
    if "model" in axes and axes["model"] & (axes["model"] - 1):
        raise ValueError(
            f"model axis size must be a power of two (got {axes['model']}): "
            "the sharded statevector rotates log2(model) qubits per all_to_all")
    return {a: axes[a] for a in AXIS_ORDER if a in axes}


def mesh_spec_size(spec: dict) -> int:
    """Total device count a parsed mesh spec requires."""
    total = 1
    for s in spec.values():
        total *= s
    return total


def build_mesh(spec: dict, device="cuda"):
    """The `core.axis.Mesh` of a parsed spec: every axis a `LocalAxis` in
    one process, or process groups under a launcher that sets
    ``WORLD_SIZE`` > 1 (which must equal the product of the sizes)."""
    import os

    from repro_torch.core.axis import Mesh

    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        return Mesh.from_env(spec, device)
    return Mesh.local(spec)



# --------------------------------------------------- DeviceMesh helpers --
def mesh_axes(mesh) -> dict:
    """``{axis name: size}`` of a `DeviceMesh`, or of a mapping standing in
    for one."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _world_device_type() -> str:
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: initialise torch.distributed with as many ranks "
            "as the mesh has places (the dry-run uses a fake world)")
    return "cuda" if "nccl" in str(dist.get_backend()) else "cpu"


def device_mesh(shape, names, device_type: str | None = None):
    """A `DeviceMesh` of ``shape`` named ``names`` over the current world
    (its size must be the product of ``shape``); ``device_type`` defaults to
    ``"cuda"`` on NCCL and ``"cpu"`` otherwise."""
    from torch.distributed.device_mesh import init_device_mesh

    device_type = device_type or _world_device_type()
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device_type: str | None = None):
    """16×16 single-pod (256 places) or 2×16×16 multi-pod (512 places)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return device_mesh(shape, axes, device_type)


def make_test_mesh(data: int = 2, model: int = 4, device_type: str | None = None):
    """A small (data, model) mesh for tests over a few ranks (8 by default)."""
    return device_mesh((data, model), ("data", "model"), device_type)


def data_axes(mesh) -> tuple:
    """All batch-shardable axes present in the mesh, in canonical order."""
    axes = mesh_axes(mesh)
    return tuple(a for a in ("pod", "data") if a in axes)


def model_axis(mesh) -> str:
    return "model"
