"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: ``repro_torch`` is not ``repro``); the plain
references import nothing of the program; nothing reads the JAX era's
``benchmarks/``."""
import ast
import sys
from pathlib import Path

import pytest

from portbench import run as R

HERE = Path(R.__file__).resolve().parent
FILES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


def imported(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    names = set(imported(path))
    assert not names & set(R.FORBIDDEN)
    if "reference" in path.parts:
        assert "repro_torch" not in names
    assert "benchmarks/" not in path.read_text()


def test_forbidden_modules_are_named_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    assert "repro" not in R.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.fake", object())
    assert "repro" in R.forbidden_modules()
