"""Nothing under gpbench/ imports JAX or the JAX package, and the plain
reference imports nothing of the program: each import's top-level name
(the part before the first dot) compared whole, since ``vggp_tpu_torch``
begins with ``vggp_tpu``."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
JAX_NAMES = {"jax", "jaxlib", "flax", "vggp_tpu"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax_under_gpbench(path):
    assert not top_level_imports(path) & JAX_NAMES


REFERENCE = sorted((BENCH / "reference").rglob("*.py"))


@pytest.mark.parametrize("path", REFERENCE, ids=[p.name for p in REFERENCE])
def test_reference_imports_nothing_of_the_program(path):
    assert "vggp_tpu_torch" not in top_level_imports(path)
    assert top_level_imports(path) <= {"__future__", "torch", "numpy", "math", "contextlib",
                                       "dataclasses", "gpbench"}


def test_whole_name_comparison():
    """The check tells the port's name from the JAX package's."""
    from gpbench.harness import FORBIDDEN_MODULES

    assert "vggp_tpu_torch".split(".")[0] not in FORBIDDEN_MODULES
    assert "vggp_tpu.models".split(".")[0] in FORBIDDEN_MODULES


def test_a_run_loads_no_jax(small_cell):
    """The port's modules that a run imports bring no JAX with them."""
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, '.'); "
            "import gpbench.harness as h, gpbench.drivers.fit, gpbench.drivers.serve, "
            "gpbench.families.svgp_kron; "
            "import vggp_tpu_torch.models.svgp, "
            "vggp_tpu_torch.train; print(h.forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent, capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
