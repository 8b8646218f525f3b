"""What the benchmark imports: never JAX or the JAX package, and in its
reference nothing of the port."""

import ast
from pathlib import Path

import pytest

from bench_port.tests._tiny import CHECKOUT

HERE = CHECKOUT / "bench_port"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _top(name: str) -> str:
    return name.split(".")[0]


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not {_top(n) for n in _imports(path)} & FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    for path in sorted((HERE / "reference").rglob("*.py")):
        for name in _imports(path):
            assert _top(name) != "repro_torch", f"{path.name} imports {name}"
            if _top(name) == "bench_port":
                assert name.startswith("bench_port.reference"), f"{path.name} imports {name}"


def test_top_level_names_are_compared_whole():
    assert _top("repro_torch.index.flat") not in FORBIDDEN
    assert _top("repro.index.flat") in FORBIDDEN
