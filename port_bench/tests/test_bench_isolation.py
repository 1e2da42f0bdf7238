"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port: compared by whole top-level names."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

from port_bench import run

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "pbnet_tpu"}


def imported_top_names(path: Path) -> set:
    """Top-level names of every absolute import in ``path``, and of every
    relative import resolved against its package."""
    tree = ast.parse(path.read_text())
    pkg = path.relative_to(HERE.parent).with_suffix("").parts[:-1]
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg[: len(pkg) - node.level + 1]
                out.add(base[0] if base else (node.module or "").split(".")[0])
            else:
                out.add(node.module.split(".")[0])
    return out


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(HERE.rglob("*.py"))
    assert files
    for f in files:
        assert not imported_top_names(f) & FORBIDDEN, f


def test_the_reference_imports_nothing_of_the_port():
    for f in sorted((HERE / "reference").rglob("*.py")):
        names = imported_top_names(f)
        assert "pbnet_torch" not in names, f
        assert names <= {"__future__", "dataclasses", "typing", "functools", "numpy", "torch",
                         "port_bench"}, (f, names)


def test_the_run_refuses_a_process_holding_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    monkeypatch.setitem(sys.modules, "pbnet_torch_extra", object())
    assert run.forbidden_modules() == [m for m in run.forbidden_modules()
                                       if m.split(".")[0] in FORBIDDEN]
    assert "jaxtyping" not in run.forbidden_modules()
    assert "pbnet_torch_extra" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax.numpy" in run.forbidden_modules()
