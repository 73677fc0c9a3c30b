"""Numpy pieces of the golden that the port needs.

Copies of ``bsr_matmul_int8_wt`` (with its int32 wrap) from
``resnet_accel_tpu/golden/gemm.py`` and of ``scale_to_q16`` and
``q16_to_scale`` from ``resnet_accel_tpu/golden/ops.py``, kept here so the
port imports nothing of the JAX package.  The LM's calibration runs its
projections through the first; the other two give the Q16.16 register of
``ops.epilogue.requantize_q16``.  The tests hold each copy equal to its
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
    C = np.zeros((M, N), dtype=np.int64)
    A64 = A.astype(np.int64)

    for br in range(num_block_rows):
        n0 = br * block_h
        nh = min(block_h, N - n0)
        if nh <= 0:
            continue
        for idx in range(int(row_ptr[br]), int(row_ptr[br + 1])):
            bc = int(col_idx[idx])
            k0 = bc * block_w
            kw = min(block_w, K - k0)
            if kw <= 0:
                continue
            a_slice = A64[:, k0:k0 + kw]                    # [M, kw]
            blk = data[idx][:nh, :kw].astype(np.int64)      # [nh, kw]
            C[:, n0:n0 + nh] += a_slice @ blk.T
    return _wrap_i32(C)
