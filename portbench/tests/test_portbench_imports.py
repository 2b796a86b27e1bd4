"""What the benchmark imports: never JAX, its libraries or the JAX package,
compared by whole top-level name (the port's name begins with the JAX
package's), and the reference nothing of the program."""

import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _roots(path: Path):
    yield from _source_roots(path.read_text())


def _source_roots(source: str):
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    bad = [(str(f.relative_to(BENCH)), r) for f in files for r in _roots(f)
           if r in FORBIDDEN]
    assert bad == []


def test_the_roots_are_compared_whole():
    src = "import repro_torch.assembly\nfrom repro_torch import x\nimport repro.core\n"
    assert [r for r in _source_roots(src) if r in FORBIDDEN] == ["repro"]


def test_the_reference_imports_nothing_of_the_program():
    files = sorted((BENCH / "reference").rglob("*.py"))
    allowed = {"__future__", "dataclasses", "sys", "typing", "numpy", "torch"}
    bad = [(f.name, r) for f in files for r in _roots(f) if r not in allowed]
    assert bad == []
