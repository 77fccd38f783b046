"""What the benchmark's modules import, by top-level name compared whole:
no JAX and not the JAX package anywhere (``cudf_tpu_torch`` begins with
``cudf_tpu``, so a prefix match would be wrong), and nothing of the
program in the references. Nothing reads the repository's older
benchmarks or smoke script."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "cudf_tpu"}
SOURCES = sorted(HERE.rglob("*.py"))
RUN = [p for p in SOURCES if not p.name.startswith(("test_", "conftest"))]


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) in (
                "import_module", "find_spec") and node.args and isinstance(
                node.args[0], ast.Constant):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


def _strings(path: Path) -> list:
    """String constants that are not docstrings."""
    tree = ast.parse(path.read_text())
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef)) and n.body
            and isinstance(n.body[0], ast.Expr) and isinstance(n.body[0].value, ast.Constant)}
    return [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and id(n) not in docs]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not (_imports(path) & FORBIDDEN)


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "cudf_tpu_torch" not in _imports(path)
    assert not (_imports(path) - {"__future__", "numpy", "torch", "portbench"})


@pytest.mark.parametrize("path", RUN, ids=lambda p: str(p.relative_to(HERE)))
def test_reads_nothing_of_the_older_benchmarks(path):
    for s in _strings(path):
        assert not any(x in s for x in ("benchmarks/", "bench.py", "chip_smoke")), s


def test_the_whole_name_is_compared():
    from portbench.harness import cell

    assert "cudf_tpu_torch".split(".")[0] not in cell.FORBIDDEN
    assert cell.FORBIDDEN == FORBIDDEN
