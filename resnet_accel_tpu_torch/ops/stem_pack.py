"""The input quantize fused with the stem's 2x2 space-to-depth: kernel K6
and its plain version.

Counterpart of ``resnet_accel_tpu/ops/stem_pack.py``.  Both versions map
fp32 images [N, C, H, W] (H and W even) to int8 [N, 4C, H/2, W/2] as

    space_to_depth_nchw(quantize_input(x, scale))

that is ``clip(rint(x / scale), -128, 127)`` with the IEEE divide, then the
2x2 regrouping in channel order (c, row-parity, col-parity).
``quantize_s2d`` launches the CUDA kernel ``csrc/stem_pack.cu`` for CUDA
tensors (its output channels-last in memory, the layout the conv kernel
reads next) and runs :func:`quantize_s2d_nchw` for CPU tensors.  It is the
function of the JAX ``quantize_s2d_nm``; ``quantize_s2d_wh`` is the same
function with the spatial axes transposed, as the JAX kernel of that name
emits them (the port keeps its function, not the TPU's layout).
"""

from __future__ import annotations

import numpy as np
import torch

from resnet_accel_tpu_torch import _kernels
from resnet_accel_tpu_torch.ops.conv import space_to_depth_nchw
from resnet_accel_tpu_torch.ops.epilogue import quantize_input


def _check_even(x: torch.Tensor) -> None:
    H, W = x.shape[-2:]
    if H % 2 or W % 2:
        raise ValueError(f"H, W must be even for 2x2 s2d, got {H}x{W}")


def quantize_s2d_nchw(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain PyTorch version: ``space_to_depth_nchw(quantize_input(x,
    scale))``, [N, C, H, W] fp32 -> [N, 4C, H/2, W/2] int8."""
    _check_even(x)
    return space_to_depth_nchw(quantize_input(x, scale))


def quantize_s2d(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Fused quantize + 2x2 space-to-depth: ``x`` [N, C, H, W] fp32
    (contiguous NCHW on a card) -> [N, 4C, H/2, W/2] int8, channels-last on
    a card."""
    _check_even(x)
    if x.device.type == "cpu":
        return quantize_s2d_nchw(x, scale)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_s2d: unsupported device {x.device}")
    N, C, H, W = x.shape
    dev = x.device
    _kernels.check(x, "x", torch.float32, (N, C, H, W), dev)
    out = torch.empty((N, 4 * C, H // 2, W // 2), dtype=torch.int8,
                      device=dev, memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    _kernels.launch("stem_pack", dev, x.data_ptr(), out.data_ptr(), N, C, H,
                    W, float(scale))
    return out


def quantize_s2d_wh(x: torch.Tensor, scale: float) -> torch.Tensor:
    """[N, C, H, W] fp32 -> [N, 4C, W/2, H/2] int8: :func:`quantize_s2d`
    with the spatial axes swapped, the function of the JAX
    ``quantize_s2d_wh``."""
    return quantize_s2d(x, scale).transpose(2, 3)


def transpose_taps(w2d: np.ndarray, in_c: int, kernel: int) -> np.ndarray:
    """Swap a flattened conv weight's kh and kw taps: [O, C*k*k] in
    (c, kh, kw) order -> (c, kw, kh).  A conv of the spatially transposed
    activation with these weights is the transposed conv."""
    O = w2d.shape[0]
    w4 = np.asarray(w2d).reshape(O, in_c, kernel, kernel)
    return np.ascontiguousarray(w4.swapaxes(2, 3).reshape(O, -1))
