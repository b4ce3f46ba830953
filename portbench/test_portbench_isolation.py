"""The benchmark stands apart: no module under ``portbench/`` imports JAX
or the JAX package (top-level names compared whole: the port's
``specdec_tpu_torch`` is allowed), and the plain reference, with what it
imports and the family files it loads, loads nothing of the program. A
family file may import the program only inside ``build_layers``, its
hook into the program's build; the modules every family shares name
none."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "specdec_tpu")
SOURCES = sorted((ROOT / "portbench").rglob("*.py"))
FAMILIES = sorted((ROOT / "portbench" / "families").glob("*.py"))
SHARED = ("weights", "reference", "measure", "harness", "run", "check")


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


def _program_imports(tree):
    """Imports of the program outside a ``build_layers`` function."""
    hook = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == "build_layers":
            hook.update(id(n) for n in ast.walk(node))
    for node in ast.walk(tree):
        if id(node) in hook:
            continue
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        yield from (m for m in names
                    if m.split(".")[0] == "specdec_tpu_torch")


@pytest.mark.parametrize("path", FAMILIES, ids=lambda p: p.name)
def test_family_is_yardstick(path):
    assert not list(_program_imports(ast.parse(path.read_text())))


def test_program_hook_is_the_only_program_import():
    tree = ast.parse("import numpy\n"
                     "def build_layers(cfg, dense, fmt):\n"
                     "    from specdec_tpu_torch.quant.core import x\n"
                     "def block():\n"
                     "    import specdec_tpu_torch.core.model\n")
    assert list(_program_imports(tree)) == ["specdec_tpu_torch.core.model"]


@pytest.mark.parametrize("name", SHARED)
def test_shared_module_names_no_family(name):
    text = (ROOT / "portbench" / f"{name}.py").read_text().lower()
    families = {p.stem for p in FAMILIES} | {"qwen2"}
    assert families and not [f for f in families if f in text]


def test_reference_loads_no_program():
    code = ("import sys, json, glob, portbench.reference, portbench.check; "
            "from portbench.weights import family; "
            "[family(json.load(open(f))) for f in "
            "glob.glob('portbench/configs/*.json')]; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('specdec_tpu_torch', 'jax', 'specdec_tpu')]; "
            "assert not bad, bad; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr
