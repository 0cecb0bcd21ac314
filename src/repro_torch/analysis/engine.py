"""reprolint core for the port: module model, project index, and the
analysis entry points (port of ``repro/analysis/engine.py``; stdlib ``ast``
only, it imports nothing of the code it reads).

The rule modules (``repro_torch/analysis/rules/``) consume three layers
built here:

  ``ModuleInfo``
      One parsed source file: AST, name-binding table (import aliases and
      ``from``-names resolved to dotted paths), per-line suppression
      comments, and the ``qualify`` resolver that turns an ``ast.Name`` /
      ``ast.Attribute`` chain into a dotted name ("ops.cutvals" →
      "repro_torch.kernels.ops.cutvals").
  ``Project``
      All modules together: a function index (top-level defs, methods and
      nested defs under their dotted path), a name-resolved call graph,
      the *dispatch-sensitivity* fixpoint (which functions transitively
      reach the mutable dispatch state: the kernel selection of
      `kernels.ops` and the block-shape state of `kernels.tuning`; the
      cache-key rule's input), and the *replayed* set: code that runs once
      and is replayed later, where a host value read while it runs is
      baked in (the body of a ``with torch.cuda.graph(...)`` block, the
      callable of `torch.utils.checkpoint.checkpoint`,
      `torch.cuda.make_graphed_callables` and `torch.compile` (where it
      is a parameter, the callables the callers pass), and the functions
      they reach; the host-read and nondeterminism rules' input).
  ``run`` / ``run_on_sources``
      The entry points: parse, build the project, apply the requested rules,
      drop suppressed findings, split the rest against the baseline.

Static analysis over Python is necessarily approximate; every
over-approximation here errs toward *fewer* findings (attribute loads
drop taint, a callable that does not resolve to a project function is
not followed) so the tool stays quiet enough to run in tier-1. Escapes
for deliberate exceptions:

  ``# reprolint: disable=<rule>[,<rule>...]``       (finding's own line)
  ``# reprolint: disable-file=<rule>[,<rule>...]``  (anywhere in the file)

and the checked-in baseline (``baseline.json`` next to this package) for
grandfathered findings — matched by content fingerprint (rule + path +
enclosing symbol + normalized source line), so findings survive
unrelated line churn but die with the code they point at.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import io
import json
import os
import re
import tokenize
from typing import Iterable, Sequence

# ---------------------------------------------------------------- findings --
_SUPPRESS_RE = re.compile(
    r"reprolint:\s*(disable(?:-file)?)\s*=\s*([\w\-, ]+)"
)


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str  # as given to the analyzer (repo-relative in CI)
    line: int
    col: int
    message: str
    symbol: str = ""  # dotted enclosing-def chain, "" at module level
    line_text: str = ""  # stripped source line, for the fingerprint

    @property
    def fingerprint(self) -> str:
        """Content-based identity for baselining: stable under line moves,
        invalidated when the offending code itself changes."""
        norm_path = self.path.replace(os.sep, "/")
        # anchor on the tail of the path so absolute vs relative
        # invocations fingerprint identically
        m = re.search(r"(?:^|/)(src/.*|tests/.*|benchmarks/.*)$", norm_path)
        tail = m.group(1) if m else norm_path
        key = "|".join(
            (self.rule, tail, self.symbol, " ".join(self.line_text.split()))
        )
        return hashlib.sha1(key.encode()).hexdigest()[:16]

    def as_dict(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "symbol": self.symbol,
            "fingerprint": self.fingerprint,
        }

    def render(self) -> str:
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: " \
               f"{self.message}{sym}"


# ------------------------------------------------------------ module model --
_PACKAGE = "repro_torch"

def _module_name(path: str) -> str:
    """Dotted module name from a path: anchored at the last `repro_torch`
    package component when present (src/repro_torch/core/qaoa.py →
    repro_torch.core.qaoa), else the path itself dotted (fixture snippets
    in tests)."""
    norm = path.replace(os.sep, "/")
    parts = [p for p in norm.split("/") if p]
    if parts and parts[-1].endswith(".py"):
        parts[-1] = parts[-1][: -len(".py")]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    if _PACKAGE in parts:
        at = len(parts) - 1 - parts[::-1].index(_PACKAGE)
        parts = parts[at:]
    return ".".join(parts)


class ModuleInfo:
    """One parsed source file with its binding table and suppressions."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.modname = _module_name(path)
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        # name → dotted target, merged over every Import/ImportFrom in the
        # file regardless of scope (good enough for a linter; later imports
        # shadow earlier ones, as at runtime)
        self.bindings: dict[str, str] = {}
        self._collect_bindings()
        self.line_suppressions: dict[int, set[str]] = {}
        self.file_suppressions: set[str] = set()
        self._collect_suppressions()

    # -- imports --
    def _collect_bindings(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    name = alias.asname or alias.name.split(".")[0]
                    target = alias.name if alias.asname else alias.name.split(".")[0]
                    self.bindings[name] = target
            elif isinstance(node, ast.ImportFrom):
                if node.level:  # relative import: resolve against modname
                    base = self.modname.split(".")
                    base = base[: len(base) - node.level]
                    mod = ".".join(base + ([node.module] if node.module else []))
                else:
                    mod = node.module or ""
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    name = alias.asname or alias.name
                    self.bindings[name] = f"{mod}.{alias.name}" if mod else alias.name

    # -- suppressions --
    def _collect_suppressions(self) -> None:
        try:
            tokens = tokenize.generate_tokens(io.StringIO(self.source).readline)
            comments = [
                (tok.start[0], tok.string)
                for tok in tokens
                if tok.type == tokenize.COMMENT
            ]
        except (tokenize.TokenError, IndentationError):  # partial files
            comments = [
                (i + 1, line)
                for i, line in enumerate(self.lines)
                if "#" in line
            ]
        for lineno, text in comments:
            m = _SUPPRESS_RE.search(text)
            if not m:
                continue
            rules = {r.strip() for r in m.group(2).split(",") if r.strip()}
            if m.group(1) == "disable-file":
                self.file_suppressions |= rules
            else:
                self.line_suppressions.setdefault(lineno, set()).update(rules)

    def suppressed(self, rule: str, line: int) -> bool:
        if rule in self.file_suppressions:
            return True
        return rule in self.line_suppressions.get(line, set())

    # -- name resolution --
    def qualify(self, node: ast.AST) -> str | None:
        """Dotted name of a Name/Attribute chain, import-resolved at the
        root ("qaoa_mod.solve_subgraph_batch" →
        "repro_torch.core.qaoa.solve_subgraph_batch"). None for anything that is
        not a plain dotted chain."""
        parts: list[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        root = self.bindings.get(node.id, node.id)
        parts.append(root)
        return ".".join(reversed(parts))

    def finding(
        self, rule: str, node: ast.AST, message: str, symbol: str = ""
    ) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        text = self.lines[line - 1].strip() if 0 < line <= len(self.lines) else ""
        return Finding(rule, self.path, line, col, message, symbol, text)


# ----------------------------------------------------------- project index --
_OPS_MODULE = "repro_torch.kernels.ops"
_TUNING_MODULE = "repro_torch.kernels.tuning"
# reads of the mutable dispatch state, by module: calling a dispatched op
# reads the block-shape tuning state (every kernel's geometry comes from
# `tuning.param`); `tuning.state` reads it outright. `using_state` /
# `using_overrides` are the keying / override mechanisms, not reads. The
# kernel-or-plain choice reads only the tensor's device, no state.
_OPS_STATE_READS = frozenset(
    {
        "cutvals", "cutvals_at", "apply_phase", "apply_mixer",
        "apply_mixer_bits", "apply_layer", "expectation", "cut_batch_dense",
    }
)
_STATE_READS: dict[str, frozenset] = {
    _OPS_MODULE: _OPS_STATE_READS,
    _TUNING_MODULE: frozenset({"param", "state", "active_config", "enabled"}),
}

# replayed regions: a with-block whose body is captured, and calls whose
# callable argument runs once and is replayed (or re-run in the backward
# pass); wrapper → index/keyword of the callable argument(s)
_CAPTURE_BLOCKS = frozenset({"torch.cuda.graph", "torch.cuda.graphs.graph"})
_REPLAY_WRAPPERS: dict[str, tuple] = {
    "torch.utils.checkpoint.checkpoint": (0, "function"),
    "torch.cuda.make_graphed_callables": (0, "callables"),
    "torch.cuda.graphs.make_graphed_callables": (0, "callables"),
    "torch.compile": (0, "model"),
    "functools.partial": tuple(),  # unwrapped explicitly below
}

_FuncNode = (ast.FunctionDef, ast.AsyncFunctionDef)


def _param_positions(node: ast.AST) -> dict[str, int]:
    """A function's positional-or-keyword parameters by position."""
    a = node.args
    return {p.arg: i for i, p in enumerate(a.posonlyargs + a.args)}


def state_read(qual: str | None) -> bool:
    """Is the dotted name a read of the mutable dispatch state?"""
    if not qual or "." not in qual:
        return False
    mod, name = qual.rsplit(".", 1)
    return name in _STATE_READS.get(mod, ())


@dataclasses.dataclass
class FnInfo:
    qualname: str  # module.dotted.path
    module: ModuleInfo
    node: ast.AST  # FunctionDef / Lambda
    outer: str  # qualname of the outermost enclosing def (itself if top)


class Project:
    """All analyzed modules plus the cross-module facts rules share."""

    def __init__(self, modules: Sequence[ModuleInfo]):
        self.modules = list(modules)
        self.fn_index: dict[str, FnInfo] = {}
        # per-module: bare name → [qualnames] (any scope), for same-module
        # bare-call resolution
        self._by_name: dict[str, dict[str, list[str]]] = {}
        self._fn_of_node: dict[ast.AST, FnInfo] = {}
        for mod in self.modules:
            self._index_module(mod)
        # module-level aliases (`batch = functools.partial(solve, ...)`):
        # alias qualname → project functions its defining expression
        # references
        self.alias_deps: dict[str, set[str]] = {}
        for mod in self.modules:
            self._index_aliases(mod)
        self.impl_sensitive: set[str] = self._sensitivity_fixpoint()
        # the body of every capture block: (module, with-node, enclosing
        # function or None)
        self.capture_blocks: list[tuple[ModuleInfo, ast.With, FnInfo | None]] = []
        self.replayed: set[ast.AST] = self.closure(self._replayed_roots())

    # -- indexing --
    def _index_module(self, mod: ModuleInfo) -> None:
        by_name = self._by_name.setdefault(mod.modname, {})

        def visit(node: ast.AST, prefix: str, outer: str | None):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, _FuncNode):
                    qual = f"{prefix}.{child.name}"
                    info = FnInfo(qual, mod, child, outer or qual)
                    self.fn_index[qual] = info
                    self._fn_of_node[child] = info
                    by_name.setdefault(child.name, []).append(qual)
                    visit(child, qual, outer or qual)
                elif isinstance(child, ast.ClassDef):
                    visit(child, f"{prefix}.{child.name}", outer)
                else:
                    visit(child, prefix, outer)

        visit(mod.tree, mod.modname, None)

    def _index_aliases(self, mod: ModuleInfo) -> None:
        by_name = self._by_name.setdefault(mod.modname, {})
        for stmt in mod.tree.body:
            if not isinstance(stmt, ast.Assign):
                continue
            deps = set()
            for n in ast.walk(stmt.value):
                if not isinstance(n, (ast.Name, ast.Attribute)):
                    continue
                q = mod.qualify(n)
                if q in self.fn_index:
                    deps.add(q)
                elif isinstance(n, ast.Name):
                    # same-module top-level def referenced bare
                    # (`batch = functools.partial(solve, ...)`) — imports don't
                    # bind it, so qualify() can't
                    local = f"{mod.modname}.{n.id}"
                    if local in self.fn_index:
                        deps.add(local)
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    qual = f"{mod.modname}.{t.id}"
                    self.alias_deps[qual] = deps
                    by_name.setdefault(t.id, []).append(qual)

    def functions(self) -> Iterable[FnInfo]:
        return self.fn_index.values()

    # -- dispatch sensitivity (cache-key rule input) --
    def _direct_state_read(self, mod: ModuleInfo, fn_node: ast.AST) -> bool:
        return any(
            isinstance(node, (ast.Attribute, ast.Name))
            and state_read(mod.qualify(node))
            for node in ast.walk(fn_node)
        )

    def _bare_name_targets(
        self, mod: ModuleInfo, name: str, outer: str | None
    ) -> list[str]:
        """Same-module functions a bare name can legally refer to from a
        scope whose outermost enclosing def is `outer`: top-level defs,
        module-level aliases, and nested defs of the *same* outer function.
        (Without the outer filter, a local variable `run` in one factory
        would alias the unrelated nested def `run` of another.)"""
        out = []
        for q in self._by_name.get(mod.modname, {}).get(name, []):
            if q == f"{mod.modname}.{name}" or q in self.alias_deps:
                out.append(q)
            else:
                info = self.fn_index.get(q)
                if info is not None and outer is not None and \
                        info.outer == outer:
                    out.append(q)
        return out

    def _call_targets(
        self, mod: ModuleInfo, fn_node: ast.AST, outer: str | None = None
    ) -> set[str]:
        """Qualified names this function's body references that resolve to
        indexed project functions (calls and bare-name mentions — a
        function passed to checkpoint/partial is reached as surely as one
        called)."""
        out: set[str] = set()
        if outer is None:
            info = self._fn_of_node.get(fn_node)
            outer = info.outer if info is not None else None
        for node in ast.walk(fn_node):
            if not isinstance(node, (ast.Name, ast.Attribute)):
                continue
            qual = mod.qualify(node)
            if qual is None:
                continue
            if qual in self.fn_index or qual in self.alias_deps:
                out.add(qual)
            elif qual.endswith(".apply"):
                # `Fn.apply(...)` of a `torch.autograd.Function`: its
                # forward runs now, its backward in the backward pass
                base = qual[: -len(".apply")]
                if isinstance(node.value, ast.Name) and \
                        f"{base}.forward" not in self.fn_index:
                    base = f"{mod.modname}.{node.value.id}"
                out.update(q for q in (f"{base}.forward", f"{base}.backward")
                           if q in self.fn_index)
            elif isinstance(node, ast.Name):
                out.update(self._bare_name_targets(mod, node.id, outer))
        return out

    def _sensitivity_fixpoint(self) -> set[str]:
        sensitive: set[str] = set()
        deps: dict[str, set[str]] = dict(self.alias_deps)
        for fn in self.functions():
            # seed: the state readers themselves, when their module is part
            # of the analyzed tree (their bodies read the module state
            # through bare names this walker cannot see)
            if state_read(fn.qualname):
                sensitive.add(fn.qualname)
        for fn in self.functions():
            # nested defs are walked as part of their own entry too, so a
            # nested direct read marks both the inner fn and (via the call
            # edge below) anything that references it
            if self._direct_state_read(fn.module, fn.node):
                sensitive.add(fn.qualname)
            deps[fn.qualname] = self._call_targets(fn.module, fn.node)
        changed = True
        while changed:
            changed = False
            for name, d in deps.items():
                if name not in sensitive and d & sensitive:
                    sensitive.add(name)
                    changed = True
        return sensitive

    def is_impl_sensitive(self, mod: ModuleInfo, node: ast.AST) -> bool:
        """Does this code (a function with its nested defs, or any
        statement) reach the mutable dispatch state, the kernel selection
        or the tuning state, directly or through project calls?"""
        if self._direct_state_read(mod, node):
            return True
        return bool(self._call_targets(mod, node) & self.impl_sensitive)

    # -- replayed regions (host-read / nondeterminism rules input) --
    def resolve_fn_arg(
        self, mod: ModuleInfo, arg: ast.AST, outer: str | None
    ) -> list[ast.AST]:
        """Function node(s) a callable argument refers to: a lambda, a
        project function by name, `functools.partial` of one, or each
        element of a tuple or list of them."""
        if isinstance(arg, ast.Lambda):
            return [arg]
        if isinstance(arg, (ast.Tuple, ast.List)):
            return [n for e in arg.elts
                    for n in self.resolve_fn_arg(mod, e, outer)]
        if isinstance(arg, ast.Call):  # functools.partial(f, ...) etc.
            qual = mod.qualify(arg.func)
            if qual in ("functools.partial", "partial") and arg.args:
                return self.resolve_fn_arg(mod, arg.args[0], outer)
            return []
        if isinstance(arg, (ast.Name, ast.Attribute)):
            qual = mod.qualify(arg)
            out = []
            if qual in self.fn_index:
                out.append(self.fn_index[qual].node)
            elif isinstance(arg, ast.Name):
                for q in self._bare_name_targets(mod, arg.id, outer):
                    if q in self.fn_index:
                        out.append(self.fn_index[q].node)
            return out
        return []

    def _replayed_roots(self) -> set[ast.AST]:
        """Functions replayed whole, and the capture blocks' bodies (kept
        in `capture_blocks`; the project functions they reach are roots)."""
        roots: set[ast.AST] = set()

        def scan(mod: ModuleInfo, node: ast.AST, outer: str | None,
                 fn: FnInfo | None):
            for child in ast.iter_child_nodes(node):
                child_outer, child_fn = outer, fn
                if isinstance(child, _FuncNode):
                    info = self._fn_of_node.get(child)
                    child_outer = info.outer if info is not None else outer
                    child_fn = info
                    for dec in child.decorator_list:
                        target = dec.func if isinstance(dec, ast.Call) else dec
                        if mod.qualify(target) in _REPLAY_WRAPPERS and \
                                mod.qualify(target) != "functools.partial":
                            roots.add(child)
                elif isinstance(child, (ast.With, ast.AsyncWith)):
                    for item in child.items:
                        ctx = item.context_expr
                        if isinstance(ctx, ast.Call) and \
                                mod.qualify(ctx.func) in _CAPTURE_BLOCKS:
                            self.capture_blocks.append((mod, child, fn))
                            for stmt in child.body:
                                targets = self._call_targets(mod, stmt, outer)
                                roots.update(
                                    self.fn_index[q].node for q in targets
                                    if q in self.fn_index
                                )
                                roots.update(
                                    self.fn_index[d].node for q in targets
                                    for d in self.alias_deps.get(q, ())
                                )
                            break
                elif isinstance(child, ast.Call):
                    spec = _REPLAY_WRAPPERS.get(mod.qualify(child.func) or "")
                    for sel in spec or ():
                        arg = None
                        if isinstance(sel, int) and sel < len(child.args):
                            arg = child.args[sel]
                        elif isinstance(sel, str):
                            arg = next((k.value for k in child.keywords
                                        if k.arg == sel), None)
                        if arg is None:
                            continue
                        roots.update(self.resolve_fn_arg(mod, arg, outer))
                        if isinstance(arg, ast.Name) and fn is not None and \
                                arg.id in _param_positions(fn.node):
                            forwarded.append((fn, arg.id))
                scan(mod, child, child_outer, child_fn)

        # a callable parameter handed to a replay wrapper (`_maybe_remat(
        # body, ...)` → `checkpoint(body, ...)`): what the callers pass
        forwarded: list[tuple[FnInfo, str]] = []
        for mod in self.modules:
            scan(mod, mod.tree, None, None)
        for fn, param in forwarded:
            roots.update(self._passed_callables(fn, param))
        return roots

    def _passed_callables(self, target: FnInfo, param: str) -> list[ast.AST]:
        """Function nodes passed as ``param`` at every call of ``target``
        in the project (one level: through a local name bound to a
        function or a `functools.partial` of one in the caller)."""
        pos = _param_positions(target.node)[param]
        out: list[ast.AST] = []
        for caller in self.functions():
            mod = caller.module
            for call in ast.walk(caller.node):
                if not isinstance(call, ast.Call):
                    continue
                if target.node not in self.resolve_fn_arg(mod, call.func,
                                                          caller.outer):
                    continue
                arg = call.args[pos] if pos < len(call.args) else next(
                    (k.value for k in call.keywords if k.arg == param), None)
                if arg is None:
                    continue
                values = [arg]
                if isinstance(arg, ast.Name):
                    values += [
                        a.value for a in ast.walk(caller.node)
                        if isinstance(a, ast.Assign) and any(
                            isinstance(t, ast.Name) and t.id == arg.id
                            for t in a.targets)
                    ]
                for v in values:
                    out.extend(self.resolve_fn_arg(mod, v, caller.outer))
        return out

    def closure(self, roots: Iterable[ast.AST]) -> set[ast.AST]:
        """Roots + lexically nested defs + the project functions they
        reference by name (transitively, across modules)."""
        reached = set(roots)
        node_to_fn = {fn.node: fn for fn in self.functions()}
        changed = True
        while changed:
            changed = False
            for node in list(reached):
                # nested defs run in the same region
                for sub in ast.walk(node):
                    if sub is not node and isinstance(sub, _FuncNode) \
                            and sub not in reached:
                        reached.add(sub)
                        changed = True
                fn = node_to_fn.get(node)
                if fn is None:
                    continue
                for qual in self._call_targets(fn.module, fn.node):
                    # an alias reference pulls in the functions behind it
                    quals = (
                        self.alias_deps[qual]
                        if qual in self.alias_deps
                        else (qual,)
                    )
                    for q in quals:
                        tnode = self.fn_index[q].node
                        if tnode not in reached:
                            reached.add(tnode)
                            changed = True
        return reached

    def info_of(self, node: ast.AST) -> FnInfo | None:
        return self._fn_of_node.get(node)

    def module_of(self, node: ast.AST) -> ModuleInfo | None:
        info = self._fn_of_node.get(node)
        return info.module if info is not None else None


# ----------------------------------------------------------------- baseline --
def load_baseline(path: str | None) -> set[str]:
    if not path or not os.path.exists(path):
        return set()
    with open(path) as f:
        data = json.load(f)
    return {entry["fingerprint"] for entry in data.get("findings", [])}


def write_baseline(path: str, findings: Sequence[Finding]) -> None:
    data = {
        "version": 1,
        "findings": [
            {
                "fingerprint": f.fingerprint,
                "rule": f.rule,
                "path": f.path.replace(os.sep, "/"),
                "symbol": f.symbol,
                "message": f.message,
            }
            for f in sorted(findings, key=lambda f: (f.path, f.line))
        ],
    }
    with open(path, "w") as f:
        json.dump(data, f, indent=2)
        f.write("\n")


# ------------------------------------------------------------- entry points --
@dataclasses.dataclass
class Report:
    findings: list[Finding]  # actionable: not suppressed, not baselined
    suppressed: int
    baselined: int
    files: int
    # suppressed findings by rule id (inline suppressions are the port's
    # only escape, so their count per rule is worth reading)
    suppressed_by_rule: dict = dataclasses.field(default_factory=dict)

    @property
    def exit_code(self) -> int:
        return 1 if self.findings else 0

    def as_dict(self) -> dict:
        return {
            "version": 1,
            "files": self.files,
            "suppressed": self.suppressed,
            "baselined": self.baselined,
            "suppressed_by_rule": dict(sorted(self.suppressed_by_rule.items())),
            "findings": [f.as_dict() for f in self.findings],
        }


def collect_files(paths: Sequence[str]) -> list[str]:
    out: list[str] = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(
                d for d in dirs if d not in ("__pycache__", ".git")
            )
            out.extend(
                os.path.join(root, f) for f in sorted(files)
                if f.endswith(".py")
            )
    return out


def run_on_sources(
    sources: dict[str, str],
    rules: Sequence[str] | None = None,
    baseline: set[str] | None = None,
) -> Report:
    """Analyze in-memory sources ({path: source}). The unit-test entry
    point — identical semantics to `run` minus the filesystem walk."""
    from repro_torch.analysis.rules import get_rules

    modules = []
    for path, src in sources.items():
        modules.append(ModuleInfo(path, src))
    project = Project(modules)

    raw: list[Finding] = []
    for rule in get_rules(rules):
        raw.extend(rule.check(project))

    by_mod = {m.path: m for m in modules}
    kept, suppressed, baselined = [], 0, 0
    by_rule: dict[str, int] = {}
    baseline = baseline or set()
    for f in raw:
        mod = by_mod.get(f.path)
        if mod is not None and mod.suppressed(f.rule, f.line):
            suppressed += 1
            by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
        elif f.fingerprint in baseline:
            baselined += 1
        else:
            kept.append(f)
    kept.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return Report(kept, suppressed, baselined, len(modules), by_rule)


def run(
    paths: Sequence[str],
    rules: Sequence[str] | None = None,
    baseline_path: str | None = None,
) -> Report:
    files = collect_files(paths)
    sources = {}
    for path in files:
        with open(path, encoding="utf-8") as f:
            sources[path] = f.read()
    return run_on_sources(
        sources, rules=rules, baseline=load_baseline(baseline_path)
    )
