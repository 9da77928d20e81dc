"""The PyTorch port stands alone: ``mmlspark_tpu_torch`` and ``chip_smoke.py``
import no jax, flax or optax, and nothing of the JAX package — only the
tests import both. Nor do they import sklearn, pandas, pyarrow,
matplotlib, cv2, PIL or requests when a module is imported (the card's
machine has none of them): such an import may only sit inside the function that needs
it (``DataFrame.fromPandas``, ``plot.confusionMatrix``, ``io.arrow``'s
readers, ``io.image``'s GIF/TIFF/WebP decode). Nor does any port file name
a path under the JAX package (the native runtime's C++ sources are the
port's own copy)."""

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "mmlspark_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mmlspark_tpu")
NOT_ON_THE_CARD = ("sklearn", "pandas", "pyarrow", "matplotlib", "cv2",
                   "PIL", "requests")


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


def _module_level_imports(path: Path) -> set:
    """Modules imported when ``path`` is imported: every import outside a
    function body (class bodies and top-level blocks run at import)."""
    names = set()
    todo = [ast.parse(path.read_text(), str(path))]
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
        todo.extend(ast.iter_child_nodes(node))
    return names


def _forbidden(names, roots=FORBIDDEN) -> list:
    return sorted(n for n in names
                  if n.split(".")[0] in roots)


def test_importing_the_port_loads_no_jax():
    code = ("import sys, json, mmlspark_tpu_torch, "
            "mmlspark_tpu_torch.models.torch_model, "
            "mmlspark_tpu_torch.ops.flash_attention, "
            "mmlspark_tpu_torch.models.trainer, "
            "mmlspark_tpu_torch.parallel.prefetch, "
            "mmlspark_tpu_torch.parallel.mesh, "
            "mmlspark_tpu_torch.parallel.distributed, "
            "mmlspark_tpu_torch.parallel.dataplane, "
            "mmlspark_tpu_torch.parallel.collectives, "
            "mmlspark_tpu_torch.parallel.plan, "
            "mmlspark_tpu_torch.parallel.pipeline_parallel, "
            "mmlspark_tpu_torch.parallel.sequence, "
            "mmlspark_tpu_torch.models.moe, "
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
            "mmlspark_tpu_torch.testing.reference_datasets, "
            "mmlspark_tpu_torch.ops.text_stages, "
            "mmlspark_tpu_torch.ops.word2vec, "
            "mmlspark_tpu_torch.models.classical, "
            "mmlspark_tpu_torch.automl.featurize, "
            "mmlspark_tpu_torch.automl.train_classifier, "
            "mmlspark_tpu_torch.automl.model_statistics, "
            "mmlspark_tpu_torch.automl.tune, "
            "mmlspark_tpu_torch.stages, "
            "mmlspark_tpu_torch.telemetry, "
            "mmlspark_tpu_torch.resilience, "
            "mmlspark_tpu_torch.plot, "
            "mmlspark_tpu_torch.testing.fuzzing, "
            "mmlspark_tpu_torch.core.serialize, "
            "mmlspark_tpu_torch.native, mmlspark_tpu_torch.io, "
            "mmlspark_tpu_torch.io.arrow, mmlspark_tpu_torch.io.loader, "
            "mmlspark_tpu_torch.io.image, "
            "mmlspark_tpu_torch.resilience.ckpt, "
            "mmlspark_tpu_torch.io.http, "
            "mmlspark_tpu_torch.io.http.server, "
            "mmlspark_tpu_torch.io.http.transformer, "
            "mmlspark_tpu_torch.io.http.distributed, "
            "mmlspark_tpu_torch.io.http.worker, "
            "mmlspark_tpu_torch.io.powerbi, "
            "mmlspark_tpu_torch.io.serving, "
            "mmlspark_tpu_torch.io.serving.batcher, "
            "mmlspark_tpu_torch.io.serving.step, "
            "mmlspark_tpu_torch.io.serving.engine, "
            "mmlspark_tpu_torch.io.serving.bundle; "
            "mmlspark_tpu_torch.core.serialize._ensure_registry_populated(); "
            "print(json.dumps(sorted(sys.modules)))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    loaded = json.loads(out.strip().splitlines()[-1])
    assert _forbidden(loaded) == []
    assert _forbidden(loaded, NOT_ON_THE_CARD) == []
    assert "torch" in loaded


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")
    if "_build" not in p.relative_to(PORT).parts))   # build outputs
def test_port_sources_import_no_jax(path):
    assert _forbidden(_imported_modules(ROOT / path)) == []
    assert _forbidden(_module_level_imports(ROOT / path),
                      NOT_ON_THE_CARD) == []


def _string_constants(path: Path) -> list:
    """(line, text) of every string constant that is not a docstring."""
    tree = ast.parse(path.read_text(), str(path))
    docs = {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}
    return [(node.lineno, node.value) for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and id(node) not in docs]


_JAX_PATH = re.compile(r"(^|[/\\])mmlspark_tpu($|[/\\])")


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")
    if "_build" not in p.relative_to(PORT).parts))
def test_port_sources_name_no_path_of_the_jax_package(path):
    assert [(ln, s) for ln, s in _string_constants(ROOT / path)
            if _JAX_PATH.search(s)] == []


def test_path_check_sees_a_jax_path(tmp_path):
    src = tmp_path / "m.py"
    src.write_text('"""docs may cite mmlspark_tpu/io/loader.py"""\n'
                   'import os\n'
                   'CSRC = os.path.join(ROOT, "mmlspark_tpu", "native")\n'
                   'OTHER = f"{ROOT}/mmlspark_tpu/native/csrc"\n'
                   'FINE = "mmlspark_tpu_torch/_build/native"\n')
    hits = [s for _ln, s in _string_constants(src) if _JAX_PATH.search(s)]
    assert hits == ["mmlspark_tpu", "/mmlspark_tpu/native/csrc"]


def test_native_sources_are_the_ports_own():
    from mmlspark_tpu_torch import native
    assert native.CSRC == PORT / "native" / "csrc"
    assert sorted(p.name for p in native.CSRC.iterdir()) == [
        "arrow.cc", "csvparse.cc", "decode.cc", "gbdt.cc", "loader.cc",
        "mmltpu.h", "resize.cc"]
    assert all(str(a).startswith(str(PORT)) or not a.endswith(".cc")
               for a in native.build_command())


def test_chip_smoke_imports_no_jax():
    names = _imported_modules(ROOT / "chip_smoke.py")
    assert _forbidden(names) == []
    assert _forbidden(names, NOT_ON_THE_CARD) == []
    assert "mmlspark_tpu_torch" in {n.split(".")[0] for n in names}


def test_module_level_imports_skip_function_bodies(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import numpy\nclass C:\n    import scipy\n"
                   "def f():\n    import pandas\n"
                   "if True:\n    from pyarrow import lib\n")
    assert _module_level_imports(src) == {"numpy", "scipy", "pyarrow"}


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
