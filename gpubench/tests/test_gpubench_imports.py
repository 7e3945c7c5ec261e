"""What the harness may load: never JAX or the JAX package, and in the
reference nothing of the program."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from gpubench import cell

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path: Path) -> set:
    """Top-level names of every module a file imports (absolute imports)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_harness_module_imports_jax_or_the_jax_package(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    names = imported(path)
    assert not names & (FORBIDDEN | {"repro_torch"})
    assert names <= {"__future__", "contextlib", "importlib", "math", "re", "types", "typing",
                     "numpy", "torch", "gpubench"}
    assert all(m.startswith("gpubench.reference") for m in _gpubench_modules(path))


def _gpubench_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("gpubench"):
            yield node.module


def test_names_compare_whole():
    assert "repro_torch" not in FORBIDDEN
    mods = dict(sys.modules)
    try:
        sys.modules["repro_torch_fake"] = sys.modules["sys"]
        assert cell.forbidden_modules() == sorted(FORBIDDEN & {m.split(".")[0] for m in mods})
        sys.modules["repro.fake"] = sys.modules["sys"]
        assert "repro" in cell.forbidden_modules()
    finally:
        sys.modules.pop("repro_torch_fake", None)
        sys.modules.pop("repro.fake", None)


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: this case is about running without one")
    p = subprocess.run([sys.executable, "gpubench/run.py", "--workload", "sd15-mixed-steady",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr
