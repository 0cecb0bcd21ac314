"""host-read: nothing between a dispatch and its harvest reads the card.

New in the port, in place of the reference's ``tracer-hazard``
(``repro/analysis/rules/tracer.py``), whose taint machinery it reuses.
JAX raises on a host cast of a tracer; torch does not: ``.item()``,
``float(t)`` or ``if t:`` on a CUDA tensor silently synchronises the host
with the card. Inside a dispatch that was the service's old fault: a
dispatch that reads the card waits behind every launch queued before it,
so admission stalls behind the card. Inside a CUDA graph capture the same
read fails the capture, or bakes one value into every replay. The
service's contract, that `qaoa.solve_subgraph_batch` returns once its
launches are queued, was held by one CPU test that patches the
tensor-to-host methods for one call; this rule holds it over every
dispatch root statically.

The dispatch roots are the replayed regions (`Project.replayed`: the body
of every ``with torch.cuda.graph(...)`` block and the callables of
`checkpoint` / `make_graphed_callables` / `torch.compile`, with the
functions they reach) plus the registry below: `qaoa.solve_subgraph_batch`
and `backend.solve_graphed` with everything they reach, and the decode
loop of `serving.engine.Engine.generate` (its loops only: the harvest
after the loop reads the card by design). Inside them the rule flags

  - ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()`` on a tensor;
  - ``float`` / ``int`` / ``bool`` / ``complex`` of a tensor;
  - ``if`` / ``while`` on a tensor;
  - ``torch.cuda.synchronize`` (always).

"A tensor" is a taint: every parameter, minus the declared statics (a
non-tensor annotation such as ``n: int`` or ``device: torch.device``, the
parameters of an ``lru_cache`` factory, and the host-side parameters the
registry declares per function, such as ``real_mask``, which the packer
keeps on the host), through local assignments, subscripts, arithmetic
and calls. Taint drops at attribute loads (``x.shape``, ``cfg.top_k``,
``t.device``), at ``isinstance`` / ``len`` / identity comparisons, and at
a call to a project function whose return annotation is not a tensor
(``tuning.param(...) -> int``). Every approximation errs toward fewer
findings, as the reference's does.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.engine import Finding, ModuleInfo, Project

RULE_ID = "host-read"

# dispatch roots beside the replayed regions: qualname → "body" (the whole
# function and what it reaches) or "loops" (only its loops' statements)
DISPATCH_ROOTS: dict[str, str] = {
    "repro_torch.core.qaoa.solve_subgraph_batch": "body",
    "repro_torch.service.backend.solve_graphed": "body",
    "repro_torch.serving.engine.Engine.generate": "loops",
}
# parameters that hold host values by contract, per function of a root
HOST_PARAMS: dict[str, tuple[str, ...]] = {
    "repro_torch.core.qaoa.solve_subgraph_batch": ("real_mask",),
    "repro_torch.core.qaoa.topk_marginal": ("real_mask",),
    "repro_torch.service.backend.solve_graphed": ("masks",),
}

_CASTS = {"float", "int", "bool", "complex"}
_READ_METHODS = {"item", "tolist", "cpu", "numpy"}
_SYNC = {"torch.cuda.synchronize", "torch.cuda.current_stream.synchronize"}
# attribute loads that still refer to the tensor's data
_DATA_ATTRS = {"real", "imag", "T", "mT", "H", "mH", "data"}
# calls whose result is static regardless of argument taint
_UNTAINTING_CALLS = {
    "isinstance", "len", "type", "getattr", "hasattr", "id", "repr", "str",
    "callable", "torch.is_tensor", "torch.is_grad_enabled",
}
# tensor methods that return metadata the host already holds
_STATIC_METHODS = {
    "dim", "ndimension", "numel", "nelement", "size", "stride",
    "is_contiguous", "element_size", "data_ptr", "get_device",
    "is_floating_point", "is_complex",
}
_FuncNode = (ast.FunctionDef, ast.AsyncFunctionDef)
# annotations that still mean "this is (or may be) a tensor"
_ARRAYISH = ("Tensor", "ndarray", "Array", "pytree")
_CACHE_DECORATORS = {"functools.lru_cache", "lru_cache", "functools.cache"}


def _arrayish(annotation: ast.AST) -> bool:
    text = ast.dump(annotation)
    return any(t in text for t in _ARRAYISH)


def _static_params(mod: ModuleInfo, fn: ast.AST, qualname: str) -> set[str]:
    """Params that are host configuration, never tensors on the card: a
    non-tensor annotation, an lru_cache factory's key, or a declaration
    in `HOST_PARAMS`."""
    a = fn.args
    every = a.posonlyargs + a.args + a.kwonlyargs
    static = {p.arg for p in every
              if p.annotation is not None and not _arrayish(p.annotation)}
    for dec in getattr(fn, "decorator_list", ()):
        target = dec.func if isinstance(dec, ast.Call) else dec
        if mod.qualify(target) in _CACHE_DECORATORS:
            return {p.arg for p in every}
    static.update(HOST_PARAMS.get(qualname, ()))
    return static


def walk_shallow(fn: ast.AST):
    """Walk a function body without descending into nested defs: each
    nested def is a separate entry with its own taint set."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, _FuncNode):
            stack.extend(ast.iter_child_nodes(node))


class _Taint:
    """Flow-insensitive may-be-a-tensor analysis for one function body."""

    def __init__(self, project: Project, mod: ModuleInfo, fn: ast.AST,
                 qualname: str, outer: str | None):
        self.project, self.mod, self.outer = project, mod, outer
        a = fn.args
        self.tainted: set[str] = {
            p.arg for p in a.posonlyargs + a.args + a.kwonlyargs
        }
        if a.vararg:
            self.tainted.add(a.vararg.arg)
        if a.kwarg:
            self.tainted.add(a.kwarg.arg)
        self.tainted -= _static_params(mod, fn, qualname)
        changed = True
        while changed:
            changed = False
            for node in walk_shallow(fn):
                targets = []
                if isinstance(node, ast.Assign):
                    targets, value = node.targets, node.value
                elif isinstance(node, ast.AugAssign):
                    targets, value = [node.target], node.value
                elif isinstance(node, ast.AnnAssign) and node.value:
                    if not _arrayish(node.annotation):
                        continue
                    targets, value = [node.target], node.value
                elif isinstance(node, ast.For):
                    targets, value = [node.target], node.iter
                elif isinstance(node, ast.withitem) and node.optional_vars:
                    targets, value = [node.optional_vars], node.context_expr
                else:
                    continue
                if not self.is_tainted(value):
                    continue
                for t in targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name) and \
                                n.id not in self.tainted:
                            self.tainted.add(n.id)
                            changed = True

    def _static_return(self, call: ast.Call) -> bool:
        """A call to project functions that all return a non-tensor."""
        callees = self.project.resolve_fn_arg(self.mod, call.func, self.outer)
        return bool(callees) and all(
            isinstance(c, _FuncNode) and c.returns is not None
            and not _arrayish(c.returns) for c in callees)

    def is_tainted(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            return node.attr in _DATA_ATTRS and self.is_tainted(node.value)
        if isinstance(node, ast.Subscript):
            return self.is_tainted(node.value)
        if isinstance(node, ast.BinOp):
            return self.is_tainted(node.left) or self.is_tainted(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_tainted(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self.is_tainted(v) for v in node.values)
        if isinstance(node, ast.Compare):
            # identity checks are static even on tensors
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False
            # `"key" in params`: dict-structure membership, static
            if all(isinstance(op, (ast.In, ast.NotIn)) for op in node.ops) \
                    and isinstance(node.left, ast.Constant) \
                    and isinstance(node.left.value, str):
                return False
            return self.is_tainted(node.left) or any(
                self.is_tainted(c) for c in node.comparators
            )
        if isinstance(node, ast.IfExp):
            return any(
                self.is_tainted(n) for n in (node.body, node.test, node.orelse)
            )
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any(self.is_tainted(e) for e in node.elts)
        if isinstance(node, ast.Starred):
            return self.is_tainted(node.value)
        if isinstance(node, ast.Call):
            qual = self.mod.qualify(node.func)
            if qual in _UNTAINTING_CALLS or self._static_return(node):
                return False
            if self.args_tainted(node):
                return True
            # method call on tensor data (x.sum(), x.clone()), not on its
            # metadata (x.dim(), x.numel())
            if isinstance(node.func, ast.Attribute):
                return node.func.attr not in _STATIC_METHODS and \
                    self.is_tainted(node.func.value)
            return False
        return False

    def args_tainted(self, call: ast.Call) -> bool:
        return any(self.is_tainted(a) for a in call.args) or any(
            self.is_tainted(k.value) for k in call.keywords
        )


def _loop_nodes(fn: ast.AST):
    """Every node inside the loops of ``fn``'s body (not nested defs)."""
    for node in walk_shallow(fn):
        if isinstance(node, (ast.For, ast.While, ast.AsyncFor)):
            yield node
            for stmt in node.body + node.orelse:
                yield stmt
                yield from walk_shallow(stmt)


class HostReadRule:
    id = RULE_ID
    summary = (
        "no .item()/.tolist()/.cpu()/.numpy(), host casts, tensor-valued "
        "if/while or torch.cuda.synchronize inside a dispatch"
    )

    def check(self, project: Project) -> list[Finding]:
        body_roots = [project.fn_index[q].node for q, scope in
                      DISPATCH_ROOTS.items()
                      if scope == "body" and q in project.fn_index]
        region = project.replayed | project.closure(body_roots)
        findings: list[Finding] = []
        seen: set[tuple[str, int, int]] = set()
        for fn in project.functions():
            if not isinstance(fn.node, _FuncNode):
                continue
            if fn.node in region:
                nodes = list(walk_shallow(fn.node))
            elif DISPATCH_ROOTS.get(fn.qualname) == "loops":
                nodes = list(_loop_nodes(fn.node))
            else:
                continue
            taint = _Taint(project, fn.module, fn.node, fn.qualname, fn.outer)
            symbol = fn.qualname[len(fn.module.modname) + 1:]
            for f in self._check_nodes(fn.module, taint, nodes, symbol):
                key = (f.path, f.line, f.col)
                if key not in seen:
                    seen.add(key)
                    findings.append(f)
        for mod, block, fn in project.capture_blocks:
            if fn is None:
                continue
            taint = _Taint(project, mod, fn.node, fn.qualname, fn.outer)
            symbol = fn.qualname[len(mod.modname) + 1:]
            nodes = [n for stmt in block.body
                     for n in (stmt, *walk_shallow(stmt))]
            for f in self._check_nodes(mod, taint, nodes, symbol):
                key = (f.path, f.line, f.col)
                if key not in seen:
                    seen.add(key)
                    findings.append(f)
        return findings

    def _check_nodes(self, mod: ModuleInfo, taint: _Taint, nodes,
                     symbol: str) -> list[Finding]:
        out: list[Finding] = []
        why = ("inside a dispatch: the host waits for the card here, behind "
               "every launch queued before (and a graph capture fails or "
               "bakes the value in); keep it on the card or move it to the "
               "harvest")
        for node in nodes:
            if isinstance(node, ast.Call):
                qual = mod.qualify(node.func) or ""
                if qual in _SYNC:
                    out.append(mod.finding(
                        self.id, node, f"{qual}() {why}", symbol=symbol))
                elif qual in _CASTS and taint.args_tainted(node):
                    out.append(mod.finding(
                        self.id, node, f"{qual}() of a tensor {why}",
                        symbol=symbol))
                elif isinstance(node.func, ast.Attribute) and \
                        node.func.attr in _READ_METHODS and \
                        taint.is_tainted(node.func.value):
                    out.append(mod.finding(
                        self.id, node,
                        f".{node.func.attr}() of a tensor {why}",
                        symbol=symbol))
            elif isinstance(node, (ast.If, ast.While)):
                if taint.is_tainted(node.test):
                    kind = "if" if isinstance(node, ast.If) else "while"
                    out.append(mod.finding(
                        self.id, node,
                        f"`{kind}` on a tensor {why}; use torch.where or "
                        "decide it on the host from host values",
                        symbol=symbol))
        return out


RULE = HostReadRule()
