"""The benchmark stands apart: no module under ``portbench/`` imports JAX
or the JAX package (top-level names compared whole: the port's
``specdec_tpu_torch`` is allowed), and the plain reference, with what it
imports, loads nothing of the program."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "specdec_tpu")
SOURCES = sorted((ROOT / "portbench").rglob("*.py"))


def imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = [m for m in imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("name", ["reference", "weights", "measure",
                                  "traffic"])
def test_yardstick_imports_no_program(name):
    bad = [m for m in imported(ROOT / "portbench" / f"{name}.py")
           if m.split(".")[0] == "specdec_tpu_torch"]
    assert not bad, f"{name}.py imports {bad}"


def test_reference_loads_no_program():
    code = ("import sys, portbench.reference, portbench.check; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('specdec_tpu_torch', 'jax', 'specdec_tpu')]; "
            "assert not bad, bad; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr
