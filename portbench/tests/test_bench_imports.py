"""Nothing under ``portbench/`` imports JAX, jaxlib, flax or the JAX
package, and the reference imports nothing of the port either: every
import statement of every module, compared by its whole top-level name
(the port's name begins with the JAX package's)."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
JAX_SIDE = {"jax", "jaxlib", "flax", "quda_qkxtm_multigrid_tpu"}
PORT = "quda_qkxtm_multigrid_tpu_torch"


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


MODULES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(BENCH)) for p in MODULES])
def test_no_jax(path):
    assert not top_level_imports(path) & JAX_SIDE


def test_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").rglob("*.py"):
        assert PORT not in top_level_imports(path), path


def test_the_check_compares_whole_names():
    from portbench.run import FORBIDDEN
    assert PORT.split(".")[0] not in FORBIDDEN
    assert set(FORBIDDEN) == JAX_SIDE
