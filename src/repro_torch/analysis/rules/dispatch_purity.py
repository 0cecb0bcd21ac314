"""dispatch-purity: kernel implementation modules are reachable only
through `kernels.ops` (port of ``repro/analysis/rules/dispatch_purity.py``).

Every op of the solve path goes through `repro_torch.kernels.ops`, so the
kernel selection (``auto`` / ``cuda`` / ``plain``), the launch counts and
the ledger's route notes apply the same on every path. A direct import of
a kernel module (a wrapper, ``ref``, or ``_build``, the library and
launch bookkeeping) pins its call sites below that boundary: a plain
version called directly ignores the selection, a wrapper called directly
is missing from the ledger.

Flags any import that binds a kernel implementation module, at any
scope, outside the allowed zones:

  - `repro_torch.kernels.*` itself (the implementation layer below the
    boundary: ops fans out to the wrappers, which share ``ref`` and
    ``_build``),
  - tests/ and benchmarks/ (they compare kernels with ``ref`` on purpose).

`repro_torch.kernels.ops` is importable from anywhere: it *is* the
boundary. `repro_torch.kernels.tuning` is the block-shape state that a
captured program keys and re-asserts, as it does the kernel selection;
importing it pins no call site to a kernel.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.engine import Finding, ModuleInfo, Project

RULE_ID = "dispatch-purity"

_KERNELS_PKG = "repro_torch.kernels"
_IMPL_MODULES = frozenset(
    f"{_KERNELS_PKG}.{name}"
    for name in ("cutvals", "fused_layer", "mixer", "phase", "cutbatch",
                 "betagrad", "ref", "_build")
)


def _allowed_module(mod: ModuleInfo) -> bool:
    if mod.modname == _KERNELS_PKG or \
            mod.modname.startswith(_KERNELS_PKG + "."):
        return True
    parts = mod.path.replace("\\", "/").split("/")
    return "tests" in parts or "benchmarks" in parts


def _impl_module(dotted: str) -> bool:
    """True for an implementation module or anything inside one."""
    return any(dotted == m or dotted.startswith(m + ".")
               for m in _IMPL_MODULES)


class DispatchPurityRule:
    id = RULE_ID
    summary = (
        "no direct kernels.{cutvals,fused_layer,mixer,phase,cutbatch,"
        "betagrad,ref,_build} imports outside repro_torch.kernels, tests "
        "and benchmarks"
    )

    def check(self, project: Project) -> list[Finding]:
        findings: list[Finding] = []
        for mod in project.modules:
            if _allowed_module(mod):
                continue
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.Import):
                    for alias in node.names:
                        if _impl_module(alias.name):
                            findings.append(self._flag(mod, node, alias.name))
                elif isinstance(node, ast.ImportFrom):
                    if node.level:  # relative: outside the kernels already
                        continue
                    base = node.module or ""
                    if _impl_module(base):
                        findings.append(self._flag(mod, node, base))
                    elif base == _KERNELS_PKG:
                        for alias in node.names:
                            dotted = f"{base}.{alias.name}"
                            if _impl_module(dotted):
                                findings.append(
                                    self._flag(mod, node, dotted)
                                )
        return findings

    def _flag(self, mod: ModuleInfo, node: ast.AST, dotted: str) -> Finding:
        return mod.finding(
            self.id, node,
            f"direct kernel-implementation import '{dotted}': call through "
            "repro_torch.kernels.ops so the kernel selection, the launch "
            "counts and the ledger's route reach this site",
        )


RULE = DispatchPurityRule()
