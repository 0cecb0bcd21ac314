"""The ``--mesh`` CLI spec (copy of ``repro/launch/mesh.py:26-75``).

A spec is a comma-separated ``axis=size`` list, e.g. ``model=4`` or
``data=2,model=4``. Axis names are restricted to the runtime's three roles
(`pod`/`data`/`model`) and normalized to that order; `model` must be a
power of two (the sharded statevector's qubit swap rotates log2(model)
qubits). Pure string processing. Which axes the port can run is decided
by `core.distributed.as_mesh`.
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
