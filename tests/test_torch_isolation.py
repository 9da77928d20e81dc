"""The PyTorch port stands alone: ``mmlspark_tpu_torch`` and ``chip_smoke.py``
import no jax, flax or optax, and nothing of the JAX package — only the
tests import both."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "mmlspark_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mmlspark_tpu")


def _imported_modules(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value)
    return names


def _forbidden(names) -> list:
    return sorted(n for n in names
                  if n.split(".")[0] in FORBIDDEN)


def test_importing_the_port_loads_no_jax():
    code = ("import sys, json, mmlspark_tpu_torch, "
            "mmlspark_tpu_torch.models.torch_model, "
            "mmlspark_tpu_torch.ops.flash_attention, "
            "mmlspark_tpu_torch.models.trainer, "
            "mmlspark_tpu_torch.parallel.prefetch, "
            "mmlspark_tpu_torch.models.gbdt, "
            "mmlspark_tpu_torch.models.gbdt.leafwise, "
            "mmlspark_tpu_torch.models.gbdt.efb, "
            "mmlspark_tpu_torch.ops.gbdt_kernels, "
            "mmlspark_tpu_torch.ops.image_ops, "
            "mmlspark_tpu_torch.ops.image_stages, "
            "mmlspark_tpu_torch.models.downloader, "
            "mmlspark_tpu_torch.models.image_featurizer, "
            "mmlspark_tpu_torch.models.import_weights, "
            "mmlspark_tpu_torch.testing.datagen, "
            "mmlspark_tpu_torch.core.serialize; "
            "mmlspark_tpu_torch.core.serialize._ensure_registry_populated(); "
            "print(json.dumps(sorted(sys.modules)))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    loaded = json.loads(out.strip().splitlines()[-1])
    assert _forbidden(loaded) == []
    assert "torch" in loaded


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")
    if "_build" not in p.relative_to(PORT).parts))   # build outputs
def test_port_sources_import_no_jax(path):
    assert _forbidden(_imported_modules(ROOT / path)) == []


def test_chip_smoke_imports_no_jax():
    names = _imported_modules(ROOT / "chip_smoke.py")
    assert _forbidden(names) == []
    assert "mmlspark_tpu_torch" in {n.split(".")[0] for n in names}


def test_chip_smoke_fails_without_a_card_or_a_checkout(tmp_path):
    """It prints no result and exits non-zero here (no CUDA device), and in
    a directory holding chip_smoke.py alone."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, alone)):
        r = subprocess.run([sys.executable, str(script)], cwd=str(cwd),
                           capture_output=True, text=True, timeout=120,
                           env={k: v for k, v in os.environ.items()
                                if k != "PYTHONPATH"})
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
