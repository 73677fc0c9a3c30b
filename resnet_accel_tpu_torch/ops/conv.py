"""Int8 convolution with a fused epilogue and an optional fused residual
join: kernel K2 and its plain version.

Counterpart of ``resnet_accel_tpu/ops/conv.py`` (``conv2d_int8``,
``im2col_nchw``) and of the residual-join convs of
``resnet_accel_tpu/ops/conv_bm.py``.  ``conv2d_int8`` launches the CUDA
kernel ``csrc/conv_int8.cu`` for CUDA tensors and runs
:func:`conv2d_int8_plain` for CPU tensors.  Both compute, per output
channel o,

    acc = conv(x, weight) + bias[o]                     (int32)
    q   = clip(rint(float32(relu?(acc)) * factors[o]), -128, 127)
    with a residual r and (s_main, s_res, s_out):
    q   = max(clip(rint((q*s_main + r*s_res) / s_out), -128, 127), 0)

Tensors are NCHW at this interface, as in the JAX package.  The kernel
reads activations and weights in channels-last memory order: pass ``x``,
``weight`` (OIHW) and ``residual`` as ``torch.channels_last`` tensors
(:func:`pack_weight` does it for a weight once, at load); the output comes
back channels-last, ready for the next conv.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from resnet_accel_tpu_torch import _kernels
from resnet_accel_tpu_torch.ops.epilogue import add_residual, requantize
from resnet_accel_tpu_torch.ops.matmul_int8 import matmul_int8_plain


def im2col_nchw(
    x: torch.Tensor, kernel: int, stride: int, padding: int
) -> torch.Tensor:
    """[N, C, H, W] -> [N, H_out*W_out, C*K*K] patches, row order
    (c, kh, kw) as in the golden ``im2col_int8``; zero padding."""
    N, C, H, W = x.shape
    K = kernel
    H_out = (H + 2 * padding - K) // stride + 1
    W_out = (W + 2 * padding - K) // stride + 1
    if padding > 0:
        x = F.pad(x, (padding,) * 4)
    p = torch.stack([x[:, :, kh:kh + stride * H_out:stride,
                       kw:kw + stride * W_out:stride]
                     for kh in range(K) for kw in range(K)])
    p = p.permute(1, 3, 4, 2, 0)                      # [N, Ho, Wo, C, KK]
    return p.reshape(N, H_out * W_out, C * K * K)


def pack_weight(weight2d: np.ndarray, in_channels: int, kernel: int,
                device: torch.device) -> torch.Tensor:
    """[O, C*K*K] int8 (flattened OIHW, the JAX layout) -> an OIHW tensor
    on ``device`` in channels-last memory order ([O, K, K, C] physically),
    the kernel's weight layout."""
    w = torch.from_numpy(np.ascontiguousarray(weight2d, dtype=np.int8))
    w = w.reshape(-1, in_channels, kernel, kernel).to(device)
    return w.contiguous(memory_format=torch.channels_last)


def _out_hw(H: int, W: int, kernel: int, stride: int,
            padding: int) -> Tuple[int, int]:
    return ((H + 2 * padding - kernel) // stride + 1,
            (W + 2 * padding - kernel) // stride + 1)


def conv2d_int8_plain(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    factors: torch.Tensor,
    *,
    stride: int = 1,
    padding: int = 0,
    relu: bool = False,
    residual: Optional[torch.Tensor] = None,
    res_scales: Optional[Tuple[float, float, float]] = None,
) -> torch.Tensor:
    """Plain PyTorch version: im2col, then the float64 GEMM of
    :func:`matmul_int8_plain` (exact), then the float32 epilogues."""
    N, C, H, W = x.shape
    O, _, K, _ = weight.shape
    H_out, W_out = _out_hw(H, W, K, stride, padding)
    a = im2col_nchw(x, K, stride, padding).reshape(N * H_out * W_out, -1)
    acc = matmul_int8_plain(a, weight.reshape(O, -1).t())
    acc = acc.reshape(N, H_out, W_out, O).permute(0, 3, 1, 2)
    q = requantize(acc, factors, relu=relu, bias=bias, axis=1)
    if residual is not None:
        s_main, s_res, s_out = res_scales
        q = add_residual(q, residual, s_main, s_res, s_out, relu=True)
    return q


def conv2d_int8(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    factors: torch.Tensor,
    *,
    stride: int = 1,
    padding: int = 0,
    relu: bool = False,
    residual: Optional[torch.Tensor] = None,
    res_scales: Optional[Tuple[float, float, float]] = None,
) -> torch.Tensor:
    """Fused int8 conv: ``x`` [N, C, H, W] int8, ``weight`` [O, C, K, K]
    int8, ``bias`` [O] int32, ``factors`` [O] float32 -> [N, O, Ho, Wo]
    int8.  With ``residual`` [N, O, Ho, Wo] int8 and ``res_scales`` =
    (s_main, s_res, s_out) the output is the basic block's residual join
    (with its ReLU) instead of the requantized conv."""
    if (residual is None) != (res_scales is None):
        raise ValueError("residual and res_scales go together")
    if x.device.type == "cpu":
        return conv2d_int8_plain(
            x, weight, bias, factors, stride=stride, padding=padding,
            relu=relu, residual=residual, res_scales=res_scales)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_int8: unsupported device {x.device}")
    N, C, H, W = x.shape
    O, _, K, _ = weight.shape
    if C % 4 or O % 4:
        raise ValueError(f"conv2d_int8 kernel needs C and O divisible by "
                         f"4, got C={C} O={O}")
    H_out, W_out = _out_hw(H, W, K, stride, padding)
    dev = x.device
    cl = torch.channels_last
    _kernels.check(x, "x", torch.int8, (N, C, H, W), dev, cl)
    _kernels.check(weight, "weight", torch.int8, (O, C, K, K), dev, cl)
    _kernels.check(bias, "bias", torch.int32, (O,), dev)
    _kernels.check(factors, "factors", torch.float32, (O,), dev)
    s_main = s_res = s_out = 0.0
    if residual is not None:
        _kernels.check(residual, "residual", torch.int8,
                       (N, O, H_out, W_out), dev, cl)
        s_main, s_res, s_out = res_scales
    out = torch.empty((N, O, H_out, W_out), dtype=torch.int8, device=dev,
                      memory_format=cl)
    _kernels.launch(
        "conv_int8", dev, x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        factors.data_ptr(),
        None if residual is None else residual.data_ptr(), out.data_ptr(),
        N, H, W, C, O, H_out, W_out, K, stride, padding, int(relu),
        s_main, s_res, s_out)
    return out
