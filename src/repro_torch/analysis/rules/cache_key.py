"""cache-key: a program cache must key the mutable dispatch state its
programs capture (port of ``repro/analysis/rules/cache_key.py``).

The reference's first bug of this class: a cached jitted program keyed
only on the QAOA config, while its traced body dispatched through
`kernels.ops`, which reads the active implementation at trace time; two
calls under different `ops.using_implementation` contexts shared one
program. The port picks kernel or plain version by the tensor's device
alone, so the one mutable dispatch state it has is the block-shape tuning
state (`tuning.state()`, which every wrapper reads through
`tuning.param`). The port's programs are CUDA graphs: a capture records
each launch's geometry as that state stood while it ran, and every replay
repeats it whatever the state is later. The service's bucket graphs were
once keyed without it (`service/backend.py::_graph_key`): a graph
captured with tuning off kept replaying that geometry inside
`tuning.using_overrides(...)`, where a solo solve took the new one, and
the `expectation` tile orders ⟨cut⟩'s and ∂γ's reductions, so the graphed
bits could drift from the solo solve's.

The rule, for every cache whose programs reach the tuning state (a direct
read, or a call-graph path to one, across modules):

  1. a factory decorated with `functools.lru_cache` / `functools.cache`
     re-asserts the state from a parameter, with
     ``tuning.using_state(<param>)`` in its body: the parameter puts the
     state in the cache key, the with-block makes the body agree with it;
  2. inside a cached factory or a capture (a function holding a
     ``with torch.cuda.graph(...)`` block), ``using_state(X)`` with X not
     a plain parameter is flagged outright:
     ``tuning.using_state(tuning.state())`` re-reads the global where the
     key cannot see it;
  3. a capture runs its ``torch.cuda.graph`` block inside that
     re-assertion, taken from its parameters;
  4. a module-level dict whose values come from a capture (a call that
     reaches a ``torch.cuda.graph`` block) or from the kernel libraries
     (``ctypes.CDLL``, `_build.entry`, `_build.build_all`) keys each store
     with a read of ``tuning.state()`` made in the key's expression:
     directly, through the local names it is built from, or in a key
     function it calls. Library values are held to this only where the
     code that fills the cache reads the tuning state (a variant picked
     by a tuning knob).

Callers read the state *at the call site*, outside the cache, and pass it
in, as the reference's callers pass ``tuning.state()``.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.engine import Finding, FnInfo, ModuleInfo, Project

_CACHE_DECORATORS = {
    "functools.lru_cache",
    "lru_cache",
    "functools.cache",
}
_USING_TUNE = "repro_torch.kernels.tuning.using_state"
_READ_TUNE = "repro_torch.kernels.tuning.state"
_LIBRARY_CALLS = {
    "ctypes.CDLL",
    "ctypes.cdll.LoadLibrary",
    "repro_torch.kernels._build.entry",
    "repro_torch.kernels._build.build_all",
}
_DICT_MAKERS = {"dict", "collections.OrderedDict", "collections.defaultdict"}
_FuncNode = (ast.FunctionDef, ast.AsyncFunctionDef)

RULE_ID = "cache-key"


def _is_cached_factory(mod: ModuleInfo, node: ast.AST) -> bool:
    for dec in node.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        if mod.qualify(target) in _CACHE_DECORATORS:
            return True
    return False


def _param_names(node: ast.AST) -> set[str]:
    a = node.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return set(names)


def _module_dicts(mod: ModuleInfo) -> set[str]:
    """Names a module binds to an empty dict at its top level."""
    out = set()
    for stmt in mod.tree.body:
        if isinstance(stmt, ast.Assign):
            targets, value = stmt.targets, stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets, value = [stmt.target], stmt.value
        else:
            continue
        empty = (isinstance(value, ast.Dict) and not value.keys) or (
            isinstance(value, ast.Call)
            and mod.qualify(value.func) in _DICT_MAKERS
        )
        if empty:
            out.update(t.id for t in targets if isinstance(t, ast.Name))
    return out


class CacheKeyRule:
    id = RULE_ID
    summary = (
        "lru_cache factories, CUDA-graph captures and module-level program "
        "caches must key and re-assert tuning.state()"
    )

    def check(self, project: Project) -> list[Finding]:
        findings: list[Finding] = []
        captures = {}  # capture function node → [its capture blocks]
        for mod, block, fn in project.capture_blocks:
            if fn is not None:
                captures.setdefault(fn.node, (fn, []))[1].append(block)
        for fn in project.functions():
            node = fn.node
            if not isinstance(node, _FuncNode):
                continue
            cached = _is_cached_factory(fn.module, node)
            if cached or node in captures:
                findings.extend(self._check_reasserts(fn))
            if cached:
                findings.extend(self._check_factory(project, fn))
            if node in captures:
                findings.extend(
                    self._check_capture(project, fn, captures[node][1]))
        capture_fns = set(captures)
        for mod in project.modules:
            names = _module_dicts(mod)
            if names:
                findings.extend(
                    self._check_dict_stores(project, mod, names, capture_fns))
        return findings

    # -- rule 2: re-assertions take parameters --
    def _check_reasserts(self, fn: FnInfo) -> list[Finding]:
        mod, node = fn.module, fn.node
        params = _param_names(node)
        out = []
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call) or \
                    mod.qualify(sub.func) != _USING_TUNE:
                continue
            arg = sub.args[0] if sub.args else None
            if isinstance(arg, ast.Name) and arg.id in params:
                continue
            out.append(mod.finding(
                self.id, sub,
                f"tuning.using_state() inside cached factory or capture "
                f"'{node.name}' must take a parameter, not an expression "
                "the cache key cannot see",
                symbol=node.name,
            ))
        return out

    @staticmethod
    def _reasserted(mod: ModuleInfo, node: ast.AST) -> list:
        """With-blocks of ``node`` re-asserting the tuning state from a
        parameter."""
        params = _param_names(node)
        found = []
        for sub in ast.walk(node):
            if not isinstance(sub, (ast.With, ast.AsyncWith)):
                continue
            for item in sub.items:
                call = item.context_expr
                if not isinstance(call, ast.Call) or not call.args:
                    continue
                arg = call.args[0]
                if isinstance(arg, ast.Name) and arg.id in params and \
                        mod.qualify(call.func) == _USING_TUNE:
                    found.append(sub)
        return found

    # -- rule 1: lru_cache factories --
    def _check_factory(self, project: Project, fn: FnInfo) -> list[Finding]:
        mod, node = fn.module, fn.node
        if not project.is_impl_sensitive(mod, node) or \
                self._reasserted(mod, node):
            return []
        return [mod.finding(
            self.id, node,
            f"cached factory '{node.name}' reaches the kernels.tuning "
            "dispatch state but does not key it: take the state as a "
            "parameter and wrap the body in tuning.using_state(<param>) "
            "(the reference's _solve_pool_program bug class)",
            symbol=node.name,
        )]

    # -- rule 3: captures run under the re-asserted state --
    def _check_capture(self, project: Project, fn: FnInfo,
                       blocks: list) -> list[Finding]:
        mod, node = fn.module, fn.node
        found = self._reasserted(mod, node)
        out = []
        for block in blocks:
            if not any(project.is_impl_sensitive(mod, stmt)
                       for stmt in block.body):
                continue
            if not any(block in set(ast.walk(w)) for w in found):
                out.append(mod.finding(
                    self.id, block,
                    f"capture in '{node.name}' records launches that read "
                    "the tuning state, outside tuning.using_state(<param>): "
                    "the graph can record a geometry its key does not name",
                    symbol=node.name,
                ))
        return out

    # -- rule 4: module-level program caches --
    def _check_dict_stores(self, project: Project, mod: ModuleInfo,
                           names: set[str], capture_fns: set) -> list[Finding]:
        out = []
        for fn_node, outer, stmt, cache, key, value in _stores(mod, names):
            info = project.info_of(fn_node) if fn_node is not None else None
            kind = self._program_kind(project, mod, value, outer, capture_fns)
            if kind is None:
                continue
            if kind == "capture":
                sensitive = self._capture_sensitive(project, mod, value, outer,
                                                    capture_fns)
            else:
                sensitive = project.is_impl_sensitive(mod, value) or (
                    fn_node is not None
                    and project.is_impl_sensitive(mod, fn_node))
            if not sensitive:
                continue
            if _READ_TUNE not in self._key_reads(project, mod, key, fn_node,
                                                 outer):
                symbol = ""
                if info is not None:
                    symbol = info.qualname[len(mod.modname) + 1:]
                what = ("a CUDA graph capture" if kind == "capture"
                        else "a kernel library")
                out.append(mod.finding(
                    self.id, stmt,
                    f"cache '{cache}' stores {what} that reaches the "
                    "tuning state, but its key does not carry "
                    "tuning.state(): a program made under one "
                    "state would replay under another (the bucket-graph "
                    "key fault); read the state at the call and key it",
                    symbol=symbol,
                ))
        return out

    def _callees(self, project: Project, mod: ModuleInfo, value: ast.AST,
                 outer: str | None) -> list[ast.AST]:
        if isinstance(value, ast.Call):
            return project.resolve_fn_arg(mod, value.func, outer)
        return []

    def _program_kind(self, project, mod, value, outer, capture_fns):
        if not isinstance(value, ast.Call):
            return None
        if mod.qualify(value.func) in _LIBRARY_CALLS:
            return "library"
        for callee in self._callees(project, mod, value, outer):
            reached = project.closure([callee])
            if reached & capture_fns:
                return "capture"
            for node in reached:
                cmod = project.module_of(node)
                if cmod is None:
                    continue
                if any(isinstance(c, ast.Call)
                       and cmod.qualify(c.func) in _LIBRARY_CALLS
                       for c in ast.walk(node)):
                    return "library"
        return None

    def _capture_sensitive(self, project, mod, value, outer, capture_fns):
        reached = set()
        for callee in self._callees(project, mod, value, outer):
            reached |= project.closure([callee])
        for cmod, block, fn in project.capture_blocks:
            if fn is not None and fn.node in reached and any(
                    project.is_impl_sensitive(cmod, stmt)
                    for stmt in block.body):
                return True
        return False

    def _key_reads(self, project: Project, mod: ModuleInfo, key: ast.AST,
                   fn_node: ast.AST | None, outer: str | None) -> set[str]:
        """Qualified names the key's expression reads: through the local
        names it is built from (any assignment to them in the enclosing
        function) and the bodies of the project functions it calls."""
        assigned: dict[str, list[ast.AST]] = {}
        if fn_node is not None:
            for sub in ast.walk(fn_node):
                if isinstance(sub, ast.Assign):
                    for t in sub.targets:
                        for n in ast.walk(t):
                            if isinstance(n, ast.Name):
                                assigned.setdefault(n.id, []).append(sub.value)
        reads: set[str] = set()
        seen_names: set[str] = set()
        seen_fns: set[ast.AST] = set()
        todo: list[tuple[ModuleInfo, ast.AST]] = [(mod, key)]
        while todo:
            m, expr = todo.pop()
            for n in ast.walk(expr):
                if not isinstance(n, (ast.Name, ast.Attribute)):
                    continue
                qual = m.qualify(n)
                if qual:
                    reads.add(qual)
                if isinstance(n, ast.Name) and m is mod and \
                        n.id not in seen_names:
                    seen_names.add(n.id)
                    todo.extend((mod, v) for v in assigned.get(n.id, ()))
                if isinstance(n, (ast.Name, ast.Attribute)):
                    for callee in project.resolve_fn_arg(m, n, outer):
                        if callee in seen_fns:
                            continue
                        seen_fns.add(callee)
                        cmod = project.module_of(callee)
                        if cmod is not None:
                            todo.append((cmod, callee))
        return reads


def _stores(mod: ModuleInfo, names: set[str]):
    """(enclosing function or None, its outermost def's qualname, store
    statement, cache name, key, value) of every ``X[key] = value`` and
    ``X.setdefault(key, value)`` on a module-level dict ``X``."""

    def visit(node, fn, outer, prefix):
        for child in ast.iter_child_nodes(node):
            c_fn, c_outer, c_prefix = fn, outer, prefix
            if isinstance(child, _FuncNode):
                c_prefix = f"{prefix}.{child.name}"
                c_fn, c_outer = child, outer or c_prefix
            elif isinstance(child, ast.ClassDef):
                c_prefix = f"{prefix}.{child.name}"
            if isinstance(child, ast.Assign):
                for t in child.targets:
                    if isinstance(t, ast.Subscript) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id in names:
                        yield fn, outer, child, t.value.id, t.slice, child.value
            elif isinstance(child, ast.Call) and \
                    isinstance(child.func, ast.Attribute) and \
                    child.func.attr == "setdefault" and \
                    isinstance(child.func.value, ast.Name) and \
                    child.func.value.id in names and len(child.args) == 2:
                yield (fn, outer, child, child.func.value.id, child.args[0],
                       child.args[1])
            yield from visit(child, c_fn, c_outer, c_prefix)

    yield from visit(mod.tree, None, None, mod.modname)


RULE = CacheKeyRule()
