"""Nothing under perfbench/ imports JAX or the JAX package (``repro``),
comparing each imported module's top-level name whole, and the reference
imports nothing of the solver either."""

import ast
import sys

from perfbench.lib import bench, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    """Top-level names of every module ``path`` imports."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(spec.BENCH.rglob("*.py"))
    assert len(files) > 20
    hits = [f"{f.relative_to(spec.ROOT)}: {name}" for f in files for name in _imports(f)
            if name in FORBIDDEN]
    assert not hits, hits


def test_reference_imports_nothing_of_the_solver():
    files = sorted((spec.BENCH / "reference").rglob("*.py"))
    names = {name for f in files for name in _imports(f)}
    # the standard library, numpy and torch: not the solver, nor the harness
    # that drives it
    assert names - set(sys.stdlib_module_names) <= {"numpy", "torch"}, names


def test_the_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert "repro_torch_like" not in bench.foreign_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert bench.foreign_modules() == ["repro.core"]


def test_the_solver_loads_no_jax():
    """A run on the CPU loads the solver; neither JAX nor the JAX package
    is in the process afterwards."""
    import subprocess

    code = ("import sys; sys.path[:0] = ['.', 'src']\n"
            "from perfbench.tests import tiny\n"
            "r, c, ok = tiny.run('er', seconds=0.1)\n"
            "from perfbench.lib import bench\n"
            "assert ok and not bench.foreign_modules(), bench.foreign_modules()\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
