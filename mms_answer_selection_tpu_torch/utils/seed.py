"""Seeds derived from integers: the port's stand-in for folding a JAX PRNG
key, shared by the trainers, the batch iterator and pycaffe's nets."""

from __future__ import annotations

import numpy as np


def derive_seed(*ints: int) -> int:
    """A 63-bit seed that is a fixed function of ``ints``."""
    state = np.random.SeedSequence([int(i) for i in ints]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])
