"""Nothing under ``bench/`` imports JAX, Flax, the JAX package or the smoke
script: every import's top-level name (the part before the first dot) is
compared whole, since the port's name begins with the JAX package's."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "chip_smoke"}
SOURCES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_forbidden_import(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_whole_names_are_compared():
    assert "repro_torch" not in FORBIDDEN
    assert top_level_imports(BENCH / "configs" / "sru_timit.py") >= {"torch"}


def test_a_run_loads_none_of_them(small_run):
    import harness
    small_run("sru_timit.search", 3)
    assert harness.forbidden_modules() == []
