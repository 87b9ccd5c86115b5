"""No module that the benchmark runs imports JAX or the JAX package.

Every module ``benchmark/`` imports is walked, following the imports of
``benchmark`` and of the program (``uno_tpu_torch``) through their sources;
each imported name's top level, the part before the first dot, is compared
whole, so ``uno_tpu_torch`` passes and ``uno_tpu`` does not.  The
reference imports nothing of the program.  A run checks ``sys.modules``
itself once its window has closed (``run.forbidden_modules``)."""

from __future__ import annotations

import ast
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "uno_tpu"}


def _imports(path: Path):
    """(top-level names, dotted modules) that a source file imports."""
    tree = ast.parse(path.read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:  # relative: resolve against the file's package
                pkg = path.relative_to(ROOT).parent.parts
                base = ".".join(pkg[: len(pkg) - node.level + 1])
                mod = f"{base}.{node.module}" if node.module else base
            else:
                mod = node.module
            mods.add(mod)
            mods |= {f"{mod}.{a.name}" for a in node.names}
    return {m.split(".")[0] for m in mods}, mods


def _source(mod: str):
    p = ROOT.joinpath(*mod.split("."))
    for cand in (p.with_suffix(".py"), p / "__init__.py"):
        if cand.exists():
            return cand
    return None


def _walk(files):
    seen, tops, todo = set(), set(), list(files)
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.add(f)
        t, mods = _imports(f)
        tops |= t
        for m in mods:
            if m.split(".")[0] in ("benchmark", "uno_tpu_torch"):
                src = _source(m)
                if src is not None:
                    todo.append(src)
    return tops, seen


def test_nothing_the_benchmark_runs_imports_jax():
    files = [p for p in (ROOT / "benchmark").rglob("*.py") if "tests" not in p.parts]
    tops, seen = _walk(files)
    assert not tops & FORBIDDEN, tops & FORBIDDEN
    assert any("uno_tpu_torch" in p.parts for p in seen)  # the walk reached the program


def test_the_reference_imports_nothing_of_the_program():
    files = list((ROOT / "benchmark" / "reference").rglob("*.py"))
    tops, _ = _walk(files)
    assert not tops & (FORBIDDEN | {"uno_tpu_torch"}), tops


def test_the_whole_name_is_compared():
    from benchmark import run

    assert run.FORBIDDEN == FORBIDDEN
    import sys

    sys.modules["uno_tpu_torch_like"] = sys
    try:
        assert "uno_tpu_torch_like" not in run.forbidden_modules()
        sys.modules["uno_tpu.fake"] = sys
        assert run.forbidden_modules() == ["uno_tpu.fake"]
    finally:
        sys.modules.pop("uno_tpu_torch_like", None)
        sys.modules.pop("uno_tpu.fake", None)
