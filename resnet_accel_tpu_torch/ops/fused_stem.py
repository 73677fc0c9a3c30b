"""The ImageNet stem on int8 input: kernel K10 and its plain version.

Counterpart of ``resnet_accel_tpu/ops/fused_stem.py`` (``fused_stem_pool``
and its kernels ``_stem_pool_kernel`` and ``_stem_kernel``).
``stem_conv_pool_int8`` launches the CUDA kernel ``csrc/stem_int8.cu`` for
CUDA tensors and runs :func:`stem_conv_pool_int8_plain` for CPU tensors.
Both map int8 images [N, 3, H, W] to int8 [N, 64, H', W'] as

    7x7/s2/p3 conv + bias + ReLU + requant [-> 3x3/s2/p1 max pool]

which is K1 (``ops/stem_fused.py``) without its quantize: K10 of the
quantized images equals K1 of the fp32 ones.  K10 runs K1's tensor-core
tile (``csrc/stem_mma_tile.cuh``), pooled on K1's 7 x 8 tiles or unpooled
on 16 x 16 conv tiles, on :func:`pack_stem_weight`'s [64, 192] weight;
both functions here take it or the plain [64, 3, 7, 7] OIHW weight (the
wrapper packs that on each call; ``ResNet18Int8Module`` packs once).  The
output is channels-last.

``fused_stem_pool`` is the JAX function's port: fp32 images, quantized by
the elementwise ``quantize_input`` outside the kernel as the JAX package
does it, then K10, returned as an NHWC view.
"""

from __future__ import annotations

import torch

from resnet_accel_tpu_torch import _kernels
from resnet_accel_tpu_torch.ops.conv import conv2d_int8_plain
from resnet_accel_tpu_torch.ops.epilogue import quantize_input
from resnet_accel_tpu_torch.ops.pooling import maxpool2d_int8
from resnet_accel_tpu_torch.ops.stem_fused import (
    STEM_OUT, stem_conv_hw, stem_oihw, stem_out_hw, stem_packed, stem_plan)


def stem_conv_pool_int8_plain(
    q: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    factors: torch.Tensor,
    pool: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version: the golden composition.  ``weight`` as
    :func:`stem_conv_pool_int8` takes it."""
    a = conv2d_int8_plain(q, stem_oihw(weight), bias, factors, stride=2,
                          padding=3, relu=True)
    return maxpool2d_int8(a, 3, 2, padding=1) if pool else a


def stem_conv_pool_int8(
    q: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    factors: torch.Tensor,
    pool: bool = True,
) -> torch.Tensor:
    """``q`` [N, 3, H, W] int8 (contiguous NCHW on a card), ``weight``
    [64, 3, 7, 7] int8 (packed on each call) or :func:`pack_stem_weight`'s
    [64, 192], ``bias`` [64] int32, ``factors`` [64] float32 -> [N, 64,
    H', W'] int8: pooled, or the conv's [N, 64, ceil(H/2), ceil(W/2)] with
    ``pool=False``."""
    if q.device.type == "cpu":
        return stem_conv_pool_int8_plain(q, weight, bias, factors, pool)
    if q.device.type != "cuda":
        raise ValueError(f"stem_conv_pool_int8: unsupported device "
                         f"{q.device}")
    N, _, H, W = q.shape
    Ho, Wo = stem_out_hw(H, W) if pool else stem_conv_hw(H, W)
    dev = q.device
    _kernels.check(q, "q", torch.int8, (N, 3, H, W), dev)
    weight = stem_packed(weight, dev)
    _kernels.check(bias, "bias", torch.int32, (STEM_OUT,), dev)
    _kernels.check(factors, "factors", torch.float32, (STEM_OUT,), dev)
    out = torch.empty((N, STEM_OUT, Ho, Wo), dtype=torch.int8, device=dev,
                      memory_format=torch.channels_last)
    tiles, ctas = stem_plan(N, H, W, _kernels.sm_count(dev), pool)
    if tiles == 0:
        return out
    _kernels.launch("stem_int8", dev, q.data_ptr(), weight.data_ptr(),
                    bias.data_ptr(), factors.data_ptr(), out.data_ptr(),
                    N, H, W, Ho, Wo, ctas, int(pool))
    return out


def fused_stem_pool(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    factors: torch.Tensor,
    s_input: float,
    *,
    pool: bool = True,
) -> torch.Tensor:
    """fp32 NCHW images -> the int8 NHWC stem activation
    [N, H/4, W/4, 64], or [N, H/2, W/2, 64] with ``pool=False``:
    ``quantize_input`` then :func:`stem_conv_pool_int8`."""
    N, C, H, W = x.shape
    if H % 4 or W % 4:
        raise ValueError(f"fused stem needs H, W divisible by 4, got "
                         f"{(H, W)}")
    if C != 3 or tuple(weight.shape) != (STEM_OUT, 3, 7, 7):
        raise ValueError("fused stem supports the 3-channel 7x7/s2 stem")
    q = quantize_input(x, s_input)
    return stem_conv_pool_int8(q, weight, bias, factors,
                               pool).permute(0, 2, 3, 1)
