"""Numpy pieces of the golden that the port needs.

``bsr_matmul_int8_wt`` (with its int32 wrap), the function of
``resnet_accel_tpu/golden/gemm.py`` computed as one exact float64 product
rather than a loop over the blocks, and copies of ``scale_to_q16`` and
``q16_to_scale`` from ``resnet_accel_tpu/golden/ops.py``, kept here so the
port imports nothing of the JAX package.  The LM's calibration runs its
projections through the first; the other two give the Q16.16 register of
``ops.epilogue.requantize_q16``.  The tests hold each equal to its
original.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def scale_to_q16(scale: float) -> int:
    """A float scale as the reference's Q16.16 register value: ``int(scale
    * 65536) & 0xFFFFFFFF``, truncating toward zero in double precision,
    as the reference's host code converts it."""
    return int(float(scale) * 65536.0) & 0xFFFFFFFF


def q16_to_scale(q16: int) -> float:
    """The scale a Q16.16 register applies: its 16 fraction bits only."""
    return float(q16 & 0xFFFF) / 65536.0


def _wrap_i32(x: np.ndarray) -> np.ndarray:
    """Wrap int64 values to int32 two's complement (C overflow)."""
    return x.astype(np.int64).astype(np.uint32).astype(np.int32)


def bsr_matmul_int8_wt(
    A: np.ndarray,
    data: np.ndarray,
    row_ptr: np.ndarray,
    col_idx: np.ndarray,
    block_h: int,
    block_w: int,
    N: Optional[int] = None,
) -> np.ndarray:
    """C[M, N] = A[M, K] @ W^T with W[N, K] in BSR (block rows index the
    output features, block columns the input features); int8 x int8,
    accumulated in int64 and wrapped to int32.  ``N`` defaults to the
    padded height; ``K`` may be the padded input width."""
    A = np.asarray(A, dtype=np.int8)
    data = np.asarray(data, dtype=np.int8).reshape(-1, block_h, block_w)
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    col_idx = np.asarray(col_idx, dtype=np.int64)

    M, K = A.shape
    num_block_rows = len(row_ptr) - 1
    if N is None:
        N = num_block_rows * block_h
    # The stored blocks scattered into a dense W, then one float64 product:
    # every partial sum is an integer below 2^53 in magnitude (each product
    # of two int8 values is at most 2^14, and K < 2^39), so the product is
    # exact in any order of summation, as the int64 sums are.
    nnz = int(row_ptr[-1])
    n_cols = max(-(-K // block_w), int(col_idx[:nnz].max()) + 1 if nnz
                 else 0)
    grid = np.zeros((max(num_block_rows, -(-N // block_h)), n_cols,
                     block_h, block_w), np.float64)
    rows = np.repeat(np.arange(num_block_rows), np.diff(row_ptr))
    grid[rows, col_idx[:nnz]] = data[:nnz]
    W = grid.transpose(0, 2, 1, 3).reshape(grid.shape[0] * block_h,
                                           n_cols * block_w)[:N, :K]
    C = np.rint(A.astype(np.float64) @ W.T).astype(np.int64)
    return _wrap_i32(C)
