"""Deterministic block masks for synthetic sparse weights.

A numpy copy of ``create_sparse_mask`` from
``resnet_accel_tpu/sparse/fixtures.py``, kept here so the port imports
nothing of the JAX package.  The tests hold the copy equal to its original.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def create_sparse_mask(
    shape: Tuple[int, int],
    block_size: int,
    sparsity: float,
    seed: int = 42,
) -> np.ndarray:
    """Block mask with exactly ``round(total * sparsity)`` of the
    ``block_size``-square blocks zeroed, chosen from ``seed``."""
    h, w = shape
    nbr, nbc = -(-h // block_size), -(-w // block_size)
    total = nbr * nbc
    n_zero = int(round(total * sparsity))
    rng = np.random.default_rng(seed)
    flat = np.ones(total, dtype=bool)
    zero_idx = rng.choice(total, size=n_zero, replace=False)
    flat[zero_idx] = False
    mask = np.repeat(np.repeat(flat.reshape(nbr, nbc), block_size, 0),
                     block_size, 1)
    return mask[:h, :w]
