"""The port stands alone: neither ``specdec_tpu_torch`` nor ``chip_smoke.py``
imports JAX, optax, orbax, ml_dtypes or the JAX package (the machine with
the card has none of them); importing the port's modules loads neither those nor
``transformers``, ``safetensors`` or ``tokenizers`` (the loaders import
``transformers`` only where a caller needs it)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "optax", "orbax", "ml_dtypes", "specdec_tpu")
# not loaded by importing the port either
UNLOADED = FORBIDDEN + ("transformers", "safetensors", "tokenizers")
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
            "specdec_tpu_torch.sampling.base_decoding, "
            "specdec_tpu_torch.quant.host, specdec_tpu_torch.core.hf_loader, "
            "specdec_tpu_torch.core.stream_loader, "
            "specdec_tpu_torch.engine.model_loader, "
            "specdec_tpu_torch.engine.dataset, "
            "specdec_tpu_torch.engine.monitor, "
            "specdec_tpu_torch.engine.benchmark_executor, "
            "specdec_tpu_torch.engine.benchmark_runner, "
            "specdec_tpu_torch.engine.server_benchmark, "
            "specdec_tpu_torch.engine.vllm_compat, "
            "specdec_tpu_torch.engine.optim, "
            "specdec_tpu_torch.engine.pretrain, "
            "specdec_tpu_torch.engine.distill, "
            "specdec_tpu_torch.engine.evaluate, "
            "specdec_tpu_torch.engine.eagle_train, "
            "specdec_tpu_torch.engine.checkpoint, "
            "specdec_tpu_torch.utils.printing, "
            "specdec_tpu_torch.utils.profiling, "
            "specdec_tpu_torch.cli.benchmark, "
            "specdec_tpu_torch.core.codec_model, "
            "specdec_tpu_torch.sampling.codec_decoding, "
            "specdec_tpu_torch.cli.repl, "
            "specdec_tpu_torch.parallel.pipeline; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{UNLOADED!r}]; "
            "assert not bad, bad; print('ok')")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
