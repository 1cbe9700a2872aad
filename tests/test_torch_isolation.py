"""The PyTorch port stands alone: no JAX, no ``paddle_tpu``, no CPU fallback.

  * an AST scan of every module of ``paddle_tpu_torch/`` and of
    ``chip_smoke.py``: no import of ``jax`` or of ``paddle_tpu``;
  * importing the port in a fresh interpreter loads neither;
  * with no GPU, an entry point that was not asked for the CPU raises;
  * the weight bridge raises on a missing or extra name or a bad shape.
"""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.framework.place import resolve_device
from paddle_tpu_torch.models.bridge import load_numpy_params
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _sources():
    files = sorted((ROOT / "paddle_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_covers_the_package():
    names = {p.relative_to(ROOT).as_posix() for p in _sources()}
    for must in ("paddle_tpu_torch/models/llama.py",
                 "paddle_tpu_torch/inference/continuous_batching.py",
                 "paddle_tpu_torch/ops/kernels/fusion.py",
                 "paddle_tpu_torch/ops/kernels/_build.py", "chip_smoke.py"):
        assert must in names


def test_import_loads_no_jax():
    code = ("import sys; import paddle_tpu_torch.models.llama, "
            "paddle_tpu_torch.models.bridge, paddle_tpu_torch.ops.kernels."
            "fusion, paddle_tpu_torch.ops.kernels._build, "
            "paddle_tpu_torch.inference.continuous_batching; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_need_a_gpu_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaForCausalLM(LlamaConfig.tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def _tiny_params():
    """A CPU model (its own seeded generator) and a copy of its weights."""
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", seed=0)
    return model, {n: p.detach().numpy().copy()
                   for n, p in model.named_parameters()}


def test_bridge_raises_on_missing_name():
    model, params = _tiny_params()
    params.pop("lm_head.weight")
    with pytest.raises(KeyError, match="lm_head.weight"):
        load_numpy_params(model, params)


def test_bridge_raises_on_extra_name():
    model, params = _tiny_params()
    params["model.extra.weight"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="model.extra.weight"):
        load_numpy_params(model, params)


def test_bridge_raises_on_shape_mismatch_and_copies_nothing():
    model, params = _tiny_params()
    before = model.model.norm.weight.detach().clone()
    params["model.norm.weight"] = params["model.norm.weight"] + 1.0
    params["lm_head.weight"] = params["lm_head.weight"].T.copy()
    with pytest.raises(ValueError, match="lm_head.weight"):
        load_numpy_params(model, params)
    torch.testing.assert_close(model.model.norm.weight.detach(), before)
