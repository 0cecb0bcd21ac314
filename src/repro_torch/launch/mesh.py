"""The ``--mesh`` CLI spec and the mesh it builds (the port of
``repro/launch/mesh.py``; the parser is a copy of its lines 26-75).

A spec is a comma-separated ``axis=size`` list, e.g. ``data=4`` or
``data=2,model=4``. Axis names are restricted to the runtime's three roles
(`pod`/`data`/`model`) and normalized to that order; `model` must be a
power of two (the sharded statevector's qubit swap rotates log2(model)
qubits). Parsing is pure string processing; `build_mesh` turns a parsed
spec into a `core.axis.Mesh`.
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

