"""The port stands alone: it imports no JAX, and a CUDA-only path on a
machine without CUDA raises instead of falling back to the CPU."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "mms_answer_selection_tpu_torch"

_NO_JAX = """
import sys
import mms_answer_selection_tpu_torch
import mms_answer_selection_tpu_torch.serve
import mms_answer_selection_tpu_torch.convert
import mms_answer_selection_tpu_torch.models.mms_qa
import mms_answer_selection_tpu_torch.ops.sim_cross_kernels
import mms_answer_selection_tpu_torch.ops._build
import mms_answer_selection_tpu_torch.data
import mms_answer_selection_tpu_torch.metrics
import mms_answer_selection_tpu_torch.training
import mms_answer_selection_tpu_torch.training.trainer
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "mms_answer_selection_tpu" or m.startswith("mms_answer_selection_tpu.")]
assert not bad, bad
print("clean")
"""

_NO_FALLBACK = """
import torch
from mms_answer_selection_tpu_torch import resolve_device
from mms_answer_selection_tpu_torch.serve import QueryEngine
from mms_answer_selection_tpu_torch.models.mms_qa import MMSQAConfig, mms_qa_init
from mms_answer_selection_tpu_torch.ops import sim_cross_kernels as sk
from mms_answer_selection_tpu_torch.training import Trainer, TrainerConfig
assert not torch.cuda.is_available()
for call in (lambda: resolve_device("cuda"), lambda: resolve_device(None),
             lambda: QueryEngine(mms_qa_init(MMSQAConfig(), generator=torch.Generator())[0],
                                 MMSQAConfig()),
             lambda: Trainer(MMSQAConfig(), TrainerConfig())):
    try:
        call()
    except RuntimeError as e:
        assert "cuda" in str(e).lower(), e
    else:
        raise AssertionError("a CUDA path fell back")
# the pair maps' CUDA branch builds and launches its kernel, or raises: here
# the operands are made to look as if they were on a card
q, a, w = torch.ones(2, 3, 4), torch.ones(2, 5, 4), torch.ones(1, 4, 4)
sk._on_cpu = lambda *tensors: False
for call in (lambda: sk.bilinear_pair_maps(q, a, w),
             lambda: sk.bilinear_pair_maps(q, a, w.requires_grad_()).sum().backward()):
    try:
        call()
    except RuntimeError as e:
        assert "nvcc" in str(e), e
    else:
        raise AssertionError("the pair maps fell back")
assert sum(sk.LAUNCH_COUNTS.values()) == 0
print("raised")
"""


def _run(code, cwd=ROOT, env_extra=None):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", **(env_extra or {})}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_import_leaves_jax_out():
    res = _run(_NO_JAX)
    assert res.returncode == 0 and "clean" in res.stdout, res.stderr


def test_sources_name_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|mms_answer_selection_tpu)\b",
                     re.M)
    for path in list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        assert not pat.search(path.read_text()), path


def test_cuda_paths_raise_without_cuda():
    res = _run(_NO_FALLBACK, env_extra={"CUDA_HOME": "", "PATH": "/bin"})
    assert res.returncode == 0 and "raised" in res.stdout, res.stderr


def test_chip_smoke_fails_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0 and '"ok": true' not in res.stdout
    # alone, without the package beside it, it fails too
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and '"ok": true' not in res.stdout


def test_load_library_raises_without_nvcc():
    from mms_answer_selection_tpu_torch.ops import _build

    # importing builds nothing, and the library name is keyed on the sources
    assert _build.library_path().parent == _build.BUILD_DIR
    assert len(_build._sources()) == 3
    if shutil.which("nvcc") is None and not torch.cuda.is_available():
        res = _run("from mms_answer_selection_tpu_torch.ops import _build\n"
                   "_build.load_library()", env_extra={"CUDA_HOME": "",
                                                        "PATH": "/bin"})
        assert res.returncode != 0 and "nvcc" in res.stderr
