"""Moving weights between the JAX package and this port.

The JAX package's parameter and BN-state pytrees are nested dicts of
arrays (the form ``training/checkpoint.load_checkpoint`` yields once its
leaves go through ``np.asarray``).  Both packages use the same keys and the
same layouts, so conversion is a leaf-by-leaf copy.
"""

from __future__ import annotations

import numpy as np
import torch

from .utils.tree import tree_map


def params_from_numpy(params_np, state_np, device):
    """(params, state) of numpy arrays -> the same trees as tensors on
    ``device`` (copies: no tensor aliases a caller's array)."""
    def to_torch(x):
        return torch.as_tensor(np.array(x, copy=True), device=device)
    return tree_map(to_torch, params_np), tree_map(to_torch, state_np)


def params_to_numpy(params, state):
    """Inverse of ``params_from_numpy``."""
    def to_numpy(t):
        return t.detach().cpu().numpy()
    return tree_map(to_numpy, params), tree_map(to_numpy, state)
