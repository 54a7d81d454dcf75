"""PyTorch + CUDA port of ``mms_answer_selection_tpu``.

The JAX package beside this one is the reference: every module here keeps
its counterpart's name and its public layouts (NHWC similarity maps, HWIO
conv weights in the parameter dict, ``(Nq, C)`` score matrices), so the
two can be held against each other on the same inputs and weights.

This package imports ``torch`` and never ``jax``.  The MaxSim scorers on
the serving path and the bilinear pair maps on the training path (forward
and backward) are hand-written CUDA kernels (``csrc/``) built with
``nvcc`` on their first CUDA launch (``ops/_build.py``); on CPU tensors the
same entry points run their plain PyTorch versions.
"""

from .device import resolve_device  # noqa: F401

__version__ = "0.1.0"  # the JAX package's version, which this port tracks
