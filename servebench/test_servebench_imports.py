"""Nothing the benchmark runs imports JAX or the JAX package: every module
``servebench/run.py`` can reach (its own files, the readers and span targets
it loads by name, and the port's modules they import, at any depth and in any
function) is parsed, and no import's top-level name, compared whole, is
``jax``, ``jaxlib``, ``flax`` or ``repro``."""
import ast
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SRC = ROOT / "src"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def module_file(name: str):
    """The repository file of module ``name``, or None (outside it)."""
    parts = name.split(".")
    for base in (ROOT, SRC):
        path = base.joinpath(*parts)
        if path.with_suffix(".py").is_file():
            return path.with_suffix(".py")
        if (path / "__init__.py").is_file():
            return path / "__init__.py"
    return None


def imports_of(path: Path):
    """Every module name an import statement in ``path`` names."""
    rel = path.relative_to(SRC if SRC in path.parents else ROOT)
    package = list(rel.with_suffix("").parts[:-1])
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                up = package[:len(package) - node.level + 1]
                base = ".".join(up + ([base] if base else []))
            out.add(base)
            out.update(f"{base}.{a.name}" for a in node.names)
    return out


def reachable():
    roots = [HERE / "run.py"] + sorted(HERE.rglob("*.py"))
    spans = json.loads((HERE / "spans.json").read_text())["spans"]
    names = {s["target"].split(":")[0] for s in spans}
    todo = roots + [module_file(n) for n in names]
    seen, tops = set(), set()
    while todo:
        path = todo.pop()
        if path is None or path in seen:
            continue
        seen.add(path)
        for name in imports_of(path):
            tops.add(name.split(".")[0])
            todo.append(module_file(name))
    return seen, tops


def test_benchmark_reaches_no_jax_and_no_jax_package():
    seen, tops = reachable()
    assert not tops & FORBIDDEN, sorted(tops & FORBIDDEN)
    rel = {str(p.relative_to(ROOT)) for p in seen}
    # the walk really reaches the port under test
    assert "src/repro_torch/serving/server.py" in rel
    assert "src/repro_torch/models/paged_decode.py" in rel
    assert "servebench/harness.py" in rel


def test_a_forbidden_name_is_compared_whole():
    from servebench import harness
    import sys
    assert "repro_torch" not in harness.FORBIDDEN
    sys.modules["repro_torch_lookalike.x"] = sys
    try:
        assert "repro_torch_lookalike.x" not in harness.forbidden_modules()
    finally:
        del sys.modules["repro_torch_lookalike.x"]
