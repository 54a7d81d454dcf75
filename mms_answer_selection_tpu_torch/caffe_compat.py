"""Drop-in ``caffe`` namespace for ported pycaffe scripts (counterpart of
``caffe_compat.py``).

The reference's Python package root (python/caffe/__init__.py) exports
Net, the per-type Solver classes, get_solver, NetSpec/layers/params/
to_proto, io, Classifier, Detector and the TRAIN/TEST phase constants.
This module re-exports the port's equivalents under the same names, so
existing scripts need only::

    from mms_answer_selection_tpu_torch import caffe_compat as caffe

    caffe.set_mode_gpu()                       # the card (the default)
    net = caffe.Net("deploy.prototxt", caffe.TEST)
    solver = caffe.get_solver("solver.prototxt")

The mode setters choose the device that ``Net``, the solvers,
``Classifier`` and ``Detector`` use when given no ``device=``:
``set_mode_gpu()`` the card (``set_device(i)`` picks which),
``set_mode_cpu()`` the CPU.  With no call the device is CUDA, which raises
where no card is present (the reference's Caffe starts in CPU mode; the
port runs on the card unless asked otherwise).  The JAX package's setters
are no-ops.

``caffe.proto.caffe_pb2`` is :mod:`.utils.caffe_pb2_shim` (message-style
Datum/BlobProto/NetParameter classes over the wire codec), registered as
an importable submodule, so both spellings work::

    from mms_answer_selection_tpu_torch.caffe_compat.proto import caffe_pb2
    datum = caffe.proto.caffe_pb2.Datum()
"""

from __future__ import annotations

import logging
import sys
import types

from .device import set_pycaffe_mode
from .models.classifier import Classifier  # noqa: F401
from .models.detector import Detector  # noqa: F401
from .models.graph_net import layer_type_list  # noqa: F401
from .models.pynet import Net as _PyNet
from .models.pysolver import (AdaDeltaSolver, AdaGradSolver,  # noqa: F401
                              AdamSolver, NesterovSolver, RMSPropSolver,
                              SGDSolver, Solver, get_solver)
from .utils import caffe_pb2_shim as _caffe_pb2
from .utils import io  # noqa: F401
from .utils.netspec import NetSpec, to_proto  # noqa: F401
from .utils.netspec import L as layers  # noqa: F401
from .utils.netspec import P as params  # noqa: F401

__all__ = [
    "Net", "Classifier", "Detector",
    "SGDSolver", "NesterovSolver", "AdaGradSolver", "RMSPropSolver",
    "AdaDeltaSolver", "AdamSolver", "Solver", "get_solver",
    "NetSpec", "layers", "params", "to_proto", "io", "proto",
    "layer_type_list", "TRAIN", "TEST",
    "set_mode_cpu", "set_mode_gpu", "set_device", "set_random_seed",
]

# `from <pkg>.caffe_compat.proto import caffe_pb2` must resolve like the
# reference's caffe.proto package: register synthetic submodules
proto = types.ModuleType(__name__ + ".proto")
proto.caffe_pb2 = _caffe_pb2
sys.modules[__name__ + ".proto"] = proto
sys.modules[__name__ + ".proto.caffe_pb2"] = _caffe_pb2

# _caffe.cpp exposes Phase as ints; pycaffe code only ever passes these
# through to Net/Solver, so the value just needs to round-trip
TRAIN = "train"
TEST = "test"

_log = logging.getLogger(__name__)


class Net(_PyNet):
    """pycaffe ``Net`` constructor shapes (_caffe.cpp:86-140):
    ``Net(model, phase)``, ``Net(model, weights, phase)``, and the modern
    ``Net(model, phase, weights=...)``."""

    def __init__(self, model_file: str, *args, phase=None, weights=None,
                 **kw):
        pos = list(args)
        if pos and pos[-1] in (TRAIN, TEST):
            phase = pos.pop()
        if pos:
            if weights is not None:
                raise TypeError("weights given twice")
            weights = pos.pop(0)
        if pos:
            raise TypeError(f"unexpected positional args: {pos}")
        super().__init__(model_file, phase=phase or TEST,
                         weights=weights, **kw)


def set_mode_cpu() -> None:
    """Nets and solvers made after this call run on the CPU."""
    set_pycaffe_mode("cpu")


def set_mode_gpu() -> None:
    """Nets and solvers made after this call run on the card
    (``set_device`` picks which; the default)."""
    set_pycaffe_mode("gpu")


def set_device(device_id: int) -> None:
    """The card GPU mode uses (Caffe::SetDevice; it does not switch the
    mode)."""
    set_pycaffe_mode(device_id=device_id)


def set_random_seed(seed: int) -> None:
    """Stored for callers that read it back; nets and solvers take their
    seeds explicitly (pass ``seed=`` to Net, ``random_seed`` in the solver
    prototxt)."""
    global _seed
    _seed = int(seed)
    _log.info("set_random_seed(%d): pass seed= to Net/Solver instead",
              seed)


_seed = 0
