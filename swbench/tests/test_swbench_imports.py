"""Nothing the benchmark loads imports JAX or the JAX package, and the
reference imports nothing of the program: an AST scan of every module,
comparing top-level names whole (``seqalign_tpu_torch`` begins with
``seqalign_tpu``)."""

import ast

import pytest

from swbench.tests.tiny import SWBENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "seqalign_tpu", "bench", "benchmarks", "__graft_entry__"}
PROGRAM = "seqalign_tpu_torch"
# The yardstick: what decides `correct` and makes the inputs, and what they
# import of the benchmark.
INDEPENDENT = ["reference.py", "scoring.py", "data.py", "check.py", "control.py", "peaks.py",
               "stats.py", "trace.py", "alignments.py"]
MODULES = sorted(p for p in SWBENCH.rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES + sorted((SWBENCH / "tests").glob("*.py")),
                         ids=lambda p: str(p.relative_to(SWBENCH)))
def test_no_jax_and_no_jax_package(path):
    found = top_level_imports(path)
    assert not found & FORBIDDEN
    assert not {n for n in found if n.startswith(("BENCH_", "MULTICHIP_"))}


@pytest.mark.parametrize("name", INDEPENDENT)
def test_yardstick_imports_nothing_of_the_program(name):
    assert PROGRAM not in top_level_imports(SWBENCH / name)


def test_reference_is_plain():
    """The reference takes numpy and torch and nothing else, not even the
    rest of the benchmark."""
    tree = ast.parse((SWBENCH / "reference.py").read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.level]
    assert top_level_imports(SWBENCH / "reference.py") <= {"__future__", "numpy", "torch"}


def test_whole_name_comparison():
    assert "seqalign_tpu_torch".split(".")[0] not in FORBIDDEN
