"""INT8 quantization helpers (numpy), the same formulas as
``resnet_accel_tpu/quant/quantize.py`` and ``pow2_scale`` of
``resnet_accel_tpu/ops/epilogue.py``, kept here so the port imports
nothing of the JAX package."""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

#: Guard for all-zero channels, as in ``resnet_accel_tpu.config``.
SCALE_EPS = 1e-12


def quantize_symmetric_per_channel(
    x: np.ndarray, axis: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-channel INT8 along ``axis``: max|x| -> 127."""
    x = np.asarray(x, dtype=np.float32)
    reduce_axes = tuple(i for i in range(x.ndim) if i != axis)
    maxabs = np.max(np.abs(x), axis=reduce_axes, keepdims=True)
    scales = np.maximum(maxabs / 127.0, SCALE_EPS)
    q = np.clip(np.rint(x / scales), -128, 127).astype(np.int8)
    return q, np.squeeze(scales, axis=reduce_axes).astype(np.float32)


def bias_to_int32(
    bias_fp32: np.ndarray, act_scale: float, wgt_scales: np.ndarray
) -> np.ndarray:
    """Bias in the int32 accumulator domain:
    ``rint(bias / (act_scale * wgt_scale_c))``, saturated to int32."""
    bias_fp32 = np.asarray(bias_fp32, dtype=np.float64)
    wgt_scales = np.asarray(wgt_scales, dtype=np.float64).reshape(-1)
    q = np.rint(bias_fp32 / (float(act_scale) * wgt_scales))
    # an all-zero channel's 1e-12 scale guard can blow q up; its outputs
    # are zero anyway
    q = np.nan_to_num(q, nan=0.0, posinf=2**31 - 1, neginf=-2**31)
    return np.clip(q, -2**31, 2**31 - 1).astype(np.int64).astype(np.int32)


def pow2_scale(scale: float) -> float:
    """Snap a calibrated scale up to the next power of two (a power of two
    stays): the representable range only grows, at the cost of at most
    one bit of resolution, and the reciprocal is exact."""
    s = float(np.float32(scale))
    if s <= 0 or not math.isfinite(s):
        raise ValueError(f"scale must be positive finite, got {scale}")
    m, e = math.frexp(s)            # s = m * 2**e, m in [0.5, 1)
    snapped = math.ldexp(1.0, e - 1) if m == 0.5 else math.ldexp(1.0, e)
    return float(np.float32(snapped))
