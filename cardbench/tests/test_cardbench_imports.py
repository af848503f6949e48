"""Nothing under cardbench/ imports JAX or the JAX package, and the plain
reference imports nothing of the program: every import's top-level module
name, compared whole (the program's name begins with the JAX package's)."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FILES = sorted(HERE.rglob("*.py"))


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "lisflood_tpu"}


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_no_program(path):
    assert "lisflood_tpu_torch" not in top_level_imports(path)
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.level:
            assert node.level == 1, "the reference imports only its own modules"


def test_whole_name_comparison():
    assert "lisflood_tpu" not in {"lisflood_tpu_torch"}
