"""Device resolution: an explicit device, never a silent CPU fallback."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """Return ``device`` as a ``torch.device``.

    ``None`` means ``"cuda"``: the port is built for the GPU, so a caller
    who wants the CPU says so.  Asking for CUDA where no CUDA device is
    present raises instead of falling back to the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is "
                f"False (torch {torch.__version__}); pass device='cpu' to "
                f"run the plain PyTorch paths")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {dev} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) are visible")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


# pycaffe's global mode (``caffe_compat.set_mode_cpu`` / ``set_mode_gpu`` /
# ``set_device``): the device ``models/pynet.Net`` and
# ``models/pysolver.Solver`` use when given no ``device=``.  Unset, it is
# CUDA, which raises without a card, as ``resolve_device(None)`` does.
_PYCAFFE_MODE = {"mode": "gpu", "device_id": None}


def set_pycaffe_mode(mode: str | None = None,
                     device_id: int | None = None) -> None:
    if mode is not None:
        if mode not in ("cpu", "gpu"):
            raise ValueError(f"mode must be 'cpu' or 'gpu', not {mode!r}")
        _PYCAFFE_MODE["mode"] = mode
    if device_id is not None:
        _PYCAFFE_MODE["device_id"] = int(device_id)


def pycaffe_device(device=None) -> torch.device:
    """``device`` if given, else the device pycaffe's mode names."""
    if device is None:
        if _PYCAFFE_MODE["mode"] == "cpu":
            device = "cpu"
        elif _PYCAFFE_MODE["device_id"] is not None:
            device = f"cuda:{_PYCAFFE_MODE['device_id']}"
    return resolve_device(device)
