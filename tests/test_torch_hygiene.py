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
import mms_answer_selection_tpu_torch.training.checkpoint
import mms_answer_selection_tpu_torch.training.dispatch
import mms_answer_selection_tpu_torch.utils.graphs
import mms_answer_selection_tpu_torch.utils.config
import mms_answer_selection_tpu_torch.utils.msgpack_codec
import mms_answer_selection_tpu_torch.data.loader
import mms_answer_selection_tpu_torch.data.wikiqa
import mms_answer_selection_tpu_torch.native
import mms_answer_selection_tpu_torch.serve.server
import mms_answer_selection_tpu_torch.cli
import mms_answer_selection_tpu_torch.models
import mms_answer_selection_tpu_torch.models.pair_image
import mms_answer_selection_tpu_torch.models.caption_image
import mms_answer_selection_tpu_torch.data.pair_image
import mms_answer_selection_tpu_torch.ops.losses
import mms_answer_selection_tpu_torch.ops.similarity
import mms_answer_selection_tpu_torch.utils.fillers
import mms_answer_selection_tpu_torch.utils.saliency
import mms_answer_selection_tpu_torch.utils.history
import mms_answer_selection_tpu_torch.utils.parse_log
import mms_answer_selection_tpu_torch.utils.prototxt
import mms_answer_selection_tpu_torch.utils.caffemodel
import mms_answer_selection_tpu_torch.ops.pooling
import mms_answer_selection_tpu_torch.ops.zoo
import mms_answer_selection_tpu_torch.ops.recurrent
import mms_answer_selection_tpu_torch.data.hdf5_compat
import mms_answer_selection_tpu_torch.models.graph_net
import mms_answer_selection_tpu_torch.training.graph_solver
import mms_answer_selection_tpu_torch.utils.proto_wire
import mms_answer_selection_tpu_torch.utils.caffe_pb2_shim
import mms_answer_selection_tpu_torch.utils.io
import mms_answer_selection_tpu_torch.utils.lmdb_io
import mms_answer_selection_tpu_torch.utils.leveldb_io
import mms_answer_selection_tpu_torch.data.lmdb_data
import mms_answer_selection_tpu_torch.data.window_data
import mms_answer_selection_tpu_torch.utils.netspec
import mms_answer_selection_tpu_torch.models.pynet
import mms_answer_selection_tpu_torch.models.pysolver
import mms_answer_selection_tpu_torch.caffe_compat
import mms_answer_selection_tpu_torch.models.classifier
import mms_answer_selection_tpu_torch.models.detector
import mms_answer_selection_tpu_torch.utils.draw
import mms_answer_selection_tpu_torch.utils.timer
import mms_answer_selection_tpu_torch.deploy
import mms_answer_selection_tpu_torch.matcaffe
import mms_answer_selection_tpu_torch.parallel
import mms_answer_selection_tpu_torch.parallel.collectives
import mms_answer_selection_tpu_torch.parallel.mesh
import mms_answer_selection_tpu_torch.parallel.train_step
import mms_answer_selection_tpu_torch.parallel.multihost
import mms_answer_selection_tpu_torch.parallel.launch
import mms_answer_selection_tpu_torch.parallel.dryrun
import mms_answer_selection_tpu_torch.examples
import mms_answer_selection_tpu_torch.examples.recipe_scale_rehearsal
import mms_answer_selection_tpu_torch.examples.trec_qa_mms
import mms_answer_selection_tpu_torch.examples.retrieval_1m
import mms_answer_selection_tpu_torch.examples.serve_load
import mms_answer_selection_tpu_torch.examples.int8_error_analysis
import mms_answer_selection_tpu_torch.examples.pair_image_metric
import mms_answer_selection_tpu_torch.examples.pycaffe_port
# the pair-map operator is registered, and matplotlib stays out until
# ``plot`` draws
import torch
assert torch.ops.mms_torch.pair_maps_fwd.default is not None
# h5py and PIL are imported only inside the functions that read or write
# HDF5 files or decode image files
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "flax", "msgpack", "mms_answer_selection_tpu", "h5py",
        "PIL", "matplotlib")]
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
from mms_answer_selection_tpu_torch.models.graph_net import GraphNet
from mms_answer_selection_tpu_torch.training.graph_solver import GraphSolver
from mms_answer_selection_tpu_torch import caffe_compat as caffe
assert not torch.cuda.is_available()
net = ('layer { name: "d" type: "Input" top: "x" } '
       'layer { name: "ip" type: "InnerProduct" bottom: "x" top: "y" '
       'inner_product_param { num_output: 2 } }')
solver = f'net_param {{ {net} }} base_lr: 0.1 max_iter: 1'
feeds = {"d": {"x": torch.ones(4, 3).numpy(), "batch_size": 2}}
deploy = ('input: "data" input_shape { dim: 1 dim: 3 dim: 4 dim: 4 } '
          'layer { name: "f" type: "Flatten" bottom: "data" top: "f" }')
for call in (lambda: resolve_device("cuda"), lambda: resolve_device(None),
             lambda: QueryEngine(mms_qa_init(MMSQAConfig(), generator=torch.Generator())[0],
                                 MMSQAConfig()),
             lambda: Trainer(MMSQAConfig(), TrainerConfig()),
             lambda: GraphNet(net).init(torch.Generator(), {"x": torch.ones(2, 3)}),
             lambda: GraphSolver(solver, feeds=feeds),
             # pycaffe with no mode set: the card
             lambda: caffe.Net(net, caffe.TEST),
             lambda: caffe.get_solver(solver, feeds=feeds),
             lambda: caffe.Classifier(deploy)):
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
qw, pool = torch.zeros(2, 3, 64, dtype=torch.bfloat16), torch.zeros(5, 8, 64, dtype=torch.bfloat16)
qi, qs = torch.zeros(2, 3, 64, dtype=torch.int8), torch.ones(2, 3)
aux = torch.ones(5, 2, dtype=torch.bfloat16)
for call in (lambda: sk.bilinear_pair_maps(q, a, w),
             lambda: sk.bilinear_pair_maps(q, a, w.requires_grad_()).sum().backward(),
             lambda: sk.bilinear_maxsim_scores(qw, pool),
             lambda: sk.bilinear_maxsim_scores_int8(qi, qs, torch.zeros(5, 8, 64, dtype=torch.int8), aux),
             lambda: sk.bilinear_maxsim_scores_int4(qi, qs, torch.zeros(5, 8, 32, dtype=torch.uint8), aux)):
    try:
        call()
    except RuntimeError as e:
        assert "nvcc" in str(e), e
    else:
        raise AssertionError("a kernel fell back")
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
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|msgpack|"
                     r"mms_answer_selection_tpu)\b", re.M)
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


# the kernels' sources nvcc compiles, one object each
SOURCES = ["embed_grad.cu", "maxsim_bf16.cu", "maxsim_int8.cu",
           "pair_maps.cu"]


def test_library_key_covers_headers(tmp_path, monkeypatch):
    """An edited header (csrc/*.cuh) names a new library, so a build never
    reuses one compiled from the old header."""
    from mms_answer_selection_tpu_torch.ops import _build

    for src in _build.CSRC.iterdir():
        shutil.copy(src, tmp_path / src.name)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path()
    header = tmp_path / "maxsim_wgmma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path() != before
    assert [p.name for p in _build._sources()] == SOURCES  # no headers


def test_load_library_raises_without_nvcc():
    from mms_answer_selection_tpu_torch.ops import _build

    # importing builds nothing, and the library name is keyed on the sources
    assert _build.library_path().parent == _build.BUILD_DIR
    assert [p.name for p in _build._sources()] == SOURCES
    if shutil.which("nvcc") is None and not torch.cuda.is_available():
        res = _run("from mms_answer_selection_tpu_torch.ops import _build\n"
                   "_build.load_library()", env_extra={"CUDA_HOME": "",
                                                        "PATH": "/bin"})
        assert res.returncode != 0 and "nvcc" in res.stderr
