"""collective-axis: a `torch.distributed` collective names its process
group (port of ``repro/analysis/rules/collectives.py``).

The reference's rule holds `lax.psum` and friends to a mesh axis name,
since an unbound name fails at trace time on the path that traces it.
The torch hazard is quieter: a c10d or functional collective without a
group reduces over the default group, the whole world. On a pod × data ×
model mesh that sums shards of the statevector across data rows, or a
softmax over ranks that hold other sequences, and nothing raises. The
port's convention (`core/axis.py`, `models/attention.py`) is to carry the
group in a parameter, in an attribute (`self.group`, `layout.axis.group`),
or to take it from a `DeviceMesh` by axis name, with the axes those of
`launch/mesh.py`'s ``AXIS_ORDER``: "pod", "data", "model".

Accepted group arguments:

  - a parameter of an enclosing function (the caller owns it);
  - an attribute whose last component mentions "group" or "axis";
  - ``<mesh>.get_group(<axis>)`` with a known axis literal, or an axis
    that is itself a parameter;
  - a local name every assignment of which is one of the above.

A collective with no group, or ``group=None``, is flagged, as is any
other expression (an unknown axis literal, a computed group).
"""

from __future__ import annotations

import ast
import os

from repro_torch.analysis.engine import Finding, ModuleInfo, Project

RULE_ID = "collective-axis"

_MESH_FILE = os.path.join(os.path.dirname(__file__), "..", "..", "launch",
                          "mesh.py")


def _axis_order() -> frozenset:
    """The mesh axis names, read from `launch/mesh.py`'s ``AXIS_ORDER``
    literal (parsed, never imported: the linter imports nothing it reads)."""
    try:
        with open(_MESH_FILE, encoding="utf-8") as f:
            tree = ast.parse(f.read())
    except OSError:
        return frozenset({"pod", "data", "model"})
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "AXIS_ORDER"
                for t in stmt.targets):
            return frozenset(ast.literal_eval(stmt.value))
    raise ValueError(f"no AXIS_ORDER literal in {_MESH_FILE}")


KNOWN_AXES = _axis_order()

_C10D = "torch.distributed"
_FUNCOL = "torch.distributed._functional_collectives"
# collective → positional index of its group argument (keyword ``group``)
_GROUP_ARG: dict[str, int] = {
    f"{_C10D}.all_reduce": 2,
    f"{_C10D}.all_gather": 2,
    f"{_C10D}.all_gather_into_tensor": 2,
    f"{_C10D}.all_to_all": 2,
    f"{_C10D}.all_to_all_single": 4,
    f"{_C10D}.reduce_scatter": 3,
    f"{_C10D}.reduce_scatter_tensor": 3,
    f"{_C10D}.broadcast": 2,
    f"{_C10D}.reduce": 3,
    f"{_C10D}.barrier": 0,
    f"{_FUNCOL}.all_reduce": 2,
    f"{_FUNCOL}.all_reduce_coalesced": 2,
    f"{_FUNCOL}.all_gather_tensor": 2,
    f"{_FUNCOL}.all_gather_into_tensor_coalesced": 1,
    f"{_FUNCOL}.reduce_scatter_tensor": 3,
    f"{_FUNCOL}.all_to_all_single": 3,
    f"{_FUNCOL}.broadcast": 2,
    f"{_FUNCOL}.permute_tensor": 2,
}
_GROUP_KWARG = "group"
_FuncNode = (ast.FunctionDef, ast.AsyncFunctionDef)


def _params(node: ast.AST) -> set[str]:
    a = node.args
    names = {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs}
    if a.vararg:
        names.add(a.vararg.arg)
    if a.kwarg:
        names.add(a.kwarg.arg)
    return names


def _assignments(node: ast.AST) -> dict[str, list[ast.AST]]:
    """name → the values assigned to it in one scope (not nested defs);
    a name bound by a tuple target maps to no value (not followed)."""
    out: dict[str, list[ast.AST]] = {}
    stack = list(ast.iter_child_nodes(node))
    while stack:
        sub = stack.pop()
        if isinstance(sub, ast.Assign):
            for t in sub.targets:
                if isinstance(t, ast.Name):
                    out.setdefault(t.id, []).append(sub.value)
                else:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name):
                            out.setdefault(n.id, []).append(None)
        elif isinstance(sub, (ast.AnnAssign, ast.AugAssign)) and \
                isinstance(sub.target, ast.Name):
            out.setdefault(sub.target.id, []).append(sub.value)
        elif isinstance(sub, (ast.For, ast.comprehension, ast.withitem)):
            target = getattr(sub, "target", None) or \
                getattr(sub, "optional_vars", None)
            for n in ast.walk(target) if target is not None else ():
                if isinstance(n, ast.Name):
                    out.setdefault(n.id, []).append(None)
        if not isinstance(sub, (*_FuncNode, ast.Lambda, ast.ClassDef)):
            stack.extend(ast.iter_child_nodes(sub))
    return out


class _Scope:
    def __init__(self, params: set[str], assigned: dict, parent=None):
        self.params, self.assigned, self.parent = params, assigned, parent

    def is_param(self, name: str) -> bool:
        s = self
        while s is not None:
            if name in s.params:
                return True
            if name in s.assigned:
                return False  # shadowed by a local of an inner scope
            s = s.parent
        return False

    def values(self, name: str):
        s = self
        while s is not None:
            if name in s.assigned:
                return s.assigned[name]
            s = s.parent
        return None


class CollectiveAxisRule:
    id = RULE_ID
    summary = (
        "torch.distributed collectives must name their group: a parameter, "
        "a *.group/*.axis attribute, or DeviceMesh.get_group(<mesh axis>)"
    )

    def check(self, project: Project) -> list[Finding]:
        findings: list[Finding] = []
        for mod in project.modules:
            scope = _Scope(set(), _assignments(mod.tree))
            self._visit(mod, mod.tree, scope, findings)
        return findings

    def _visit(self, mod: ModuleInfo, node: ast.AST, scope: _Scope,
               findings: list[Finding]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (*_FuncNode, ast.Lambda)):
                inner = _Scope(_params(child), _assignments(child), scope)
                self._visit(mod, child, inner, findings)
                continue
            if isinstance(child, ast.Call):
                self._check_call(mod, child, scope, findings)
            self._visit(mod, child, scope, findings)

    def _check_call(self, mod: ModuleInfo, call: ast.Call, scope: _Scope,
                    findings: list[Finding]) -> None:
        qual = mod.qualify(call.func)
        pos = _GROUP_ARG.get(qual or "")
        if pos is None:
            return
        group = None
        if len(call.args) > pos:
            group = call.args[pos]
        else:
            group = next(
                (k.value for k in call.keywords if k.arg == _GROUP_KWARG),
                None,
            )
        if group is None or (isinstance(group, ast.Constant)
                             and group.value is None):
            problem = "names no group, so it runs over the whole world"
        else:
            problem = self._group_problem(mod, group, scope, set())
        if problem:
            findings.append(mod.finding(
                self.id, call,
                f"{qual.rsplit('.', 1)[-1]} {problem}; pass the mesh axis's "
                "process group (a parameter, layout.axis.group, or "
                f"mesh.get_group(<axis>), axes {sorted(KNOWN_AXES)})",
            ))

    def _group_problem(self, mod: ModuleInfo, group: ast.AST, scope: _Scope,
                       seen: set[str]) -> str | None:
        """None when the group expression is acceptable, else a reason."""
        if isinstance(group, ast.Name):
            if scope.is_param(group.id):
                return None
            values = scope.values(group.id)
            if not values or group.id in seen:
                return f"group '{group.id}' is not a parameter or a known group"
            for v in values:
                if v is None:
                    return f"group '{group.id}' is bound where it cannot be followed"
                problem = self._group_problem(mod, v, scope, seen | {group.id})
                if problem:
                    return problem
            return None
        if isinstance(group, ast.Attribute):
            attr = group.attr.lower()
            if "group" in attr or "axis" in attr:
                return None
            return (f"group attribute '.{group.attr}' does not look like a "
                    "group handle (expected e.g. self.group, layout.axis)")
        if isinstance(group, ast.Call) and \
                isinstance(group.func, ast.Attribute) and \
                group.func.attr == "get_group":
            axis = group.args[0] if group.args else next(
                (k.value for k in group.keywords if k.arg == "mesh_dim"), None)
            if axis is None:
                return "get_group() without an axis name"
            if isinstance(axis, ast.Constant) and isinstance(axis.value, str):
                if axis.value in KNOWN_AXES:
                    return None
                return f"names unknown mesh axis '{axis.value}'"
            if isinstance(axis, ast.Name) and scope.is_param(axis.id):
                return None
            return "get_group() of an axis the linter cannot resolve"
        return "group is a computed expression the linter cannot resolve"


RULE = CollectiveAxisRule()
