"""Nothing under ``benchmark/`` imports JAX, jaxlib, flax, the JAX package
(``raggesture_tpu``), ``chip_smoke`` or ``bench_torch_k1``, comparing each
import's top-level name as a whole word (``raggesture_tpu_torch`` is not
``raggesture_tpu``); and the plain reference imports nothing of the
program (``raggesture_tpu_torch``) either."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "raggesture_tpu", "chip_smoke",
             "bench_torch_k1"}
PROGRAM = "raggesture_tpu_torch"


def top_level_imports(path: Path) -> set:
    """The top-level names of every module a file imports (absolute
    imports; a relative import stays inside ``benchmark``)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def _sources():
    return sorted(BENCH.rglob("*.py"))


def test_the_walk_sees_every_module():
    files = {p.relative_to(BENCH).as_posix() for p in _sources()}
    assert {"run.py", "harness/core.py", "reference/model.py",
            "tests/test_bench_imports.py"} <= files


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_nor_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert PROGRAM not in names and not names & FORBIDDEN


def test_whole_names_are_compared(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import raggesture_tpu_torch.models\n"
                 "from raggesture_tpu.ops import x\n")
    assert top_level_imports(f) & FORBIDDEN == {"raggesture_tpu"}
    assert PROGRAM in top_level_imports(f)
