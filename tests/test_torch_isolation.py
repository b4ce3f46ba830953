"""The port stands alone: neither ``specdec_tpu_torch`` nor ``chip_smoke.py``
imports JAX, ml_dtypes or the JAX package (the machine with the card has
none of them)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "specdec_tpu")
SOURCES = sorted((ROOT / "specdec_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_import_leaves_jax_unloaded():
    code = ("import sys, specdec_tpu_torch, specdec_tpu_torch.bench, "
            "specdec_tpu_torch.bridge, specdec_tpu_torch.serve, "
            "specdec_tpu_torch.serve.streaming, "
            "specdec_tpu_torch.engine.batch_engine, "
            "specdec_tpu_torch.core.paged_cache, "
            "specdec_tpu_torch.ops.paged_attention, "
            "specdec_tpu_torch.ops.decode_attention, "
            "specdec_tpu_torch.ops.quant_matmul, "
            "specdec_tpu_torch.ngram, specdec_tpu_torch.ngram.native, "
            "specdec_tpu_torch.ngram.device_assisted, "
            "specdec_tpu_torch.serve.nasd_scheduler, "
            "specdec_tpu_torch.engine.infer_engine, "
            "specdec_tpu_torch.engine.metrics, "
            "specdec_tpu_torch.sampling.base_decoding; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; "
            "assert not bad, bad; print('ok')")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
