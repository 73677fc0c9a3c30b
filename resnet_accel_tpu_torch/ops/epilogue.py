"""Int8 epilogues in PyTorch, bit-exact with the numpy goldens.

Counterpart of ``resnet_accel_tpu/ops/epilogue.py``.  Every float step is
one float32 operation with its own rounding, ties round half to even
(``torch.round``), results saturate to [-128, 127].

Scalars enter as one-element float32 tensors on the data's device, never
as Python floats: on CUDA, PyTorch computes ``tensor / python_float`` as a
multiply by the reciprocal, which is not the golden's divide.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def scalar_f32(value: float, device: torch.device) -> torch.Tensor:
    """``np.float32(value)`` as a one-element tensor on ``device``."""
    return torch.tensor([value], dtype=torch.float32, device=device)


def requantize(
    acc: torch.Tensor,
    factors: torch.Tensor,
    relu: bool = False,
    bias: Optional[torch.Tensor] = None,
    axis: int = -1,
) -> torch.Tensor:
    """int32 accumulator -> int8:
    ``clip(rint(float32(relu(acc + bias)) * factors), -128, 127)``.

    ``factors`` (float32, scalar or per channel along ``axis``) and
    ``bias`` (int32, per channel along ``axis``) follow the JAX function.
    """
    shape = [1] * acc.ndim
    shape[axis] = -1
    acc = acc.to(torch.int32)
    if bias is not None:
        acc = acc + bias.to(torch.int32).reshape(shape)
    if relu:
        acc = acc.clamp_min(0)
    factors = factors.to(device=acc.device, dtype=torch.float32)
    if factors.numel() > 1:
        factors = factors.reshape(shape)
    scaled = acc.to(torch.float32) * factors
    return torch.round(scaled).clamp(-128, 127).to(torch.int8)


def requantize_q16(acc: torch.Tensor, scale_q16: int,
                   relu: bool = False) -> torch.Tensor:
    """The reference's Q16.16 fixed-point requant (its output
    accumulator's datapath, golden ``requantize_q16``): int32 ``acc`` ->
    ``clip((relu(acc) * (scale_q16 & 0xFFFF)) >> 16, -128, 127)`` int8,
    the product in int64 and the shift an arithmetic one (a floor).  Only
    the register's 16 fraction bits scale; its integer bits are ignored,
    as the hardware ignores them."""
    acc = acc.to(torch.int32).to(torch.int64)
    if relu:
        acc = acc.clamp_min(0)
    scaled = (acc * (int(scale_q16) & 0xFFFF)) >> 16
    return scaled.clamp(-128, 127).to(torch.int8)


def exact_pow2_inv(scale: float) -> Optional[float]:
    """The float32 reciprocal of a power-of-two ``scale``, else None.

    When ``scale`` is 2^k, ``x / scale`` and ``x * (1 / scale)`` are the
    same float32 operation for every x (the exact quotient and product
    coincide), so a kernel may multiply instead of divide, bit for bit.
    Unlike the JAX function, this also returns None when the reciprocal
    is not a normal float32 (``scale`` >= 2^127): a device that flushes
    subnormals to zero would break the identity there.  Calibration never
    reaches such a scale (``pow2_scale`` of |x| / 127)."""
    s32 = np.float32(scale)
    if not np.isfinite(s32) or s32 <= 0:
        return None
    m, _ = np.frexp(s32)
    if m != 0.5:
        return None
    inv = np.float32(1.0) / s32
    if not np.isfinite(inv) or inv < np.finfo(np.float32).tiny:
        return None
    return float(inv)


def requant_factors(
    act_scale: float, wgt_scales: np.ndarray, out_scale: float
) -> np.ndarray:
    """float32 requant factors ``act_scale * wgt_scale / out_scale``
    (numpy, the same constants as the JAX package)."""
    in_scales = (np.float32(act_scale)
                 * np.asarray(wgt_scales, dtype=np.float32))
    return (in_scales / np.float32(out_scale)).astype(np.float32)


def exact_inv_out_scale(
    main_scale: float, residual_scale: float, out_scale: float
) -> Optional[float]:
    """A float32 reciprocal of ``out_scale`` whose multiply requantizes
    every reachable residual-join sum exactly as the golden's divide does,
    or None when no candidate passes.

    The join's inputs are int8 and its scales fixed, so the sum takes at
    most 256 x 256 values: the check is exhaustive.  The rounded
    reciprocal and its two 1-ulp neighbours are tried.
    """
    y = np.arange(-128, 128, dtype=np.float32)
    m = y * np.float32(main_scale)
    r = y * np.float32(residual_scale)
    s = m[:, None] + r[None, :]
    qd = np.clip(np.rint(s / np.float32(out_scale)), -128, 127)
    inv0 = np.float32(1.0) / np.float32(out_scale)
    for inv in (inv0, np.nextafter(inv0, np.float32(0), dtype=np.float32),
                np.nextafter(inv0, np.float32(np.inf), dtype=np.float32)):
        qm = np.clip(np.rint(s * inv), -128, 127)
        if np.array_equal(qd, qm):
            return float(inv)
    return None


def add_residual(
    main: torch.Tensor,
    residual: torch.Tensor,
    main_scale: float,
    residual_scale: float,
    out_scale: float,
    relu: bool = False,
    inv_out_scale: Optional[float] = None,
) -> torch.Tensor:
    """ResNet skip join across scales (golden ``add_residual_int8``):
    ``clip(rint((main*s_main + res*s_res) / s_out))``, then ReLU if asked.

    ``inv_out_scale`` (a proof from :func:`exact_inv_out_scale`) replaces
    the divide by a multiply; None keeps the golden divide.
    """
    dev = main.device
    m = main.to(torch.float32) * scalar_f32(main_scale, dev)
    r = residual.to(torch.float32) * scalar_f32(residual_scale, dev)
    s = m + r
    if inv_out_scale is not None:
        q = torch.round(s * scalar_f32(inv_out_scale, dev))
    else:
        q = torch.round(s / scalar_f32(out_scale, dev))
    q = q.clamp(-128, 127)
    if relu:
        q = q.clamp_min(0)
    return q.to(torch.int8)


def quantize_input(x: torch.Tensor, scale: float) -> torch.Tensor:
    """fp32 -> int8: ``clip(rint(x / scale), -128, 127)``."""
    q = torch.round(x.to(torch.float32) / scalar_f32(scale, x.device))
    return q.clamp(-128, 127).to(torch.int8)
