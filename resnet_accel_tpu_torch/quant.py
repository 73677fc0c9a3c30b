"""INT8 quantization helpers (numpy), the same formulas as
``resnet_accel_tpu/quant/quantize.py`` and ``pow2_scale`` of
``resnet_accel_tpu/ops/epilogue.py``, kept here so the port imports
nothing of the JAX package: the scales, their error statistics and the
whole-checkpoint quantizer behind the CLI's ``quantize``."""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import numpy as np

#: Guard for all-zero channels, as in ``resnet_accel_tpu.config``.
SCALE_EPS = 1e-12


def quantize_symmetric_per_tensor(
    x: np.ndarray,
) -> Tuple[np.ndarray, float]:
    """Symmetric per-tensor INT8: max|x| -> 127."""
    x = np.asarray(x, dtype=np.float32)
    maxabs = float(np.max(np.abs(x))) if x.size else 0.0
    scale = max(maxabs / 127.0, SCALE_EPS)
    q = np.clip(np.rint(x / scale), -128, 127).astype(np.int8)
    return q, scale


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


def quantize_asymmetric_per_channel(
    x: np.ndarray, axis: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Asymmetric per-channel UINT8 with signed zero-points."""
    x = np.asarray(x, dtype=np.float32)
    reduce_axes = tuple(i for i in range(x.ndim) if i != axis)
    x_min = np.min(x, axis=reduce_axes, keepdims=True)
    x_max = np.max(x, axis=reduce_axes, keepdims=True)
    scales = np.maximum((x_max - x_min) / 255.0, SCALE_EPS)
    zero_points = np.rint(-x_min / scales)
    q = np.clip(np.rint(x / scales + zero_points), 0, 255).astype(np.uint8)
    scales_flat = np.squeeze(scales, axis=reduce_axes).astype(np.float32)
    zp_flat = np.squeeze(zero_points, axis=reduce_axes).astype(np.int32)
    return q, scales_flat, zp_flat


def dequantize(
    q: np.ndarray, scale, zero_point=None, axis: int = 0
) -> np.ndarray:
    """float = (q - zp) * scale, per-channel scales broadcast on ``axis``."""
    q = np.asarray(q).astype(np.float32)
    scale = np.asarray(scale, dtype=np.float32)
    if scale.ndim > 0 and scale.size > 1:
        shape = [1] * q.ndim
        shape[axis] = -1
        scale = scale.reshape(shape)
        if zero_point is not None:
            zero_point = np.asarray(zero_point, np.float32).reshape(shape)
    if zero_point is not None:
        q = q - zero_point
    return q * scale


def compute_quantization_error(
    x_fp32: np.ndarray, x_q: np.ndarray, scale, axis: int = 0
) -> Dict[str, float]:
    """Max, mean and mean-square error and the SNR in dB of the
    dequantized reconstruction."""
    x_fp32 = np.asarray(x_fp32, dtype=np.float32)
    x_deq = dequantize(x_q, scale, axis=axis)
    error = np.abs(x_fp32 - x_deq)
    return {
        "max_error": float(np.max(error)),
        "mean_error": float(np.mean(error)),
        "mse": float(np.mean(error ** 2)),
        "snr_db": float(
            20 * np.log10(np.std(x_fp32) / (np.std(error) + 1e-12))),
    }


def quantize_params_per_channel(
    params: Mapping[str, np.ndarray],
    weight_suffix: str = "weight",
    bias_suffix: str = "bias",
) -> Dict[str, Dict]:
    """Quantize a flat dict of {layer.weight / layer.bias: fp32 array}:
    weights per output channel (axis 0), biases per tensor, as the
    reference does.  Each entry: data, scales (weights) or scale (biases),
    shape, and the error statistics."""
    out: Dict[str, Dict] = {}
    for name, arr in params.items():
        arr = np.asarray(arr, dtype=np.float32)
        if name.endswith(weight_suffix):
            q, scales = quantize_symmetric_per_channel(arr, axis=0)
            out[name] = {
                "data": q,
                "scales": scales,
                "shape": tuple(arr.shape),
                "axis": 0,
                "error": compute_quantization_error(arr, q, scales),
            }
        elif name.endswith(bias_suffix):
            q, scale = quantize_symmetric_per_tensor(arr)
            out[name] = {
                "data": q,
                "scale": scale,
                "shape": tuple(arr.shape),
                "error": compute_quantization_error(arr, q, scale),
            }
        else:
            raise ValueError(f"unrecognized param kind: {name}")
    return out


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
