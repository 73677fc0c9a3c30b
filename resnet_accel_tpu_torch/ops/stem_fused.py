"""The fused ImageNet stem: kernel K1 and its plain version.

Counterpart of ``resnet_accel_tpu/ops/stem_fused.py`` (``stem_conv_pool_nm``).
``stem_conv_pool`` launches the CUDA kernel ``csrc/stem_fused.cu`` for CUDA
tensors and runs :func:`stem_conv_pool_plain` for CPU tensors.  Both map
fp32 images [N, 3, H, W] to int8 [N, 64, H', W'] as

    quantize_input(x, scale) -> 7x7/s2/p3 conv + bias + ReLU + requant
                             -> 3x3/s2/p1 max pool

The TPU's space-to-depth regrouping of the conv is bit-identical and is
not needed on the card, so the weight stays the plain [64, 3, 7, 7] OIHW
tensor.  The kernel pools the int32 accumulators and requantizes once,
which commutes with the order above (the requant is monotone).  Its
output is channels-last in memory, the layout the conv kernel reads.
"""

from __future__ import annotations

import torch

from resnet_accel_tpu_torch import _kernels
from resnet_accel_tpu_torch.ops.conv import conv2d_int8_plain
from resnet_accel_tpu_torch.ops.epilogue import quantize_input
from resnet_accel_tpu_torch.ops.pooling import maxpool2d_int8

STEM_OUT = 64


def stem_out_hw(H: int, W: int):
    """Pooled output size of the 7x7/s2/p3 conv + 3x3/s2/p1 pool."""
    hc, wc = (H - 1) // 2 + 1, (W - 1) // 2 + 1
    return (hc - 1) // 2 + 1, (wc - 1) // 2 + 1


def stem_conv_pool_plain(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    factors: torch.Tensor,
    scale: float,
) -> torch.Tensor:
    """Plain PyTorch version: the golden composition."""
    a = quantize_input(x, scale)
    a = conv2d_int8_plain(a, weight, bias, factors, stride=2, padding=3,
                          relu=True)
    return maxpool2d_int8(a, 3, 2, padding=1)


def stem_conv_pool(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    factors: torch.Tensor,
    scale: float,
) -> torch.Tensor:
    """``x`` [N, 3, H, W] fp32, ``weight`` [64, 3, 7, 7] int8, ``bias``
    [64] int32, ``factors`` [64] float32, ``scale`` the input quantization
    scale -> [N, 64, H', W'] int8."""
    if x.device.type == "cpu":
        return stem_conv_pool_plain(x, weight, bias, factors, scale)
    if x.device.type != "cuda":
        raise ValueError(f"stem_conv_pool: unsupported device {x.device}")
    N, _, H, W = x.shape
    Hp, Wp = stem_out_hw(H, W)
    dev = x.device
    _kernels.check(x, "x", torch.float32, (N, 3, H, W), dev)
    _kernels.check(weight, "weight", torch.int8, (STEM_OUT, 3, 7, 7), dev)
    _kernels.check(bias, "bias", torch.int32, (STEM_OUT,), dev)
    _kernels.check(factors, "factors", torch.float32, (STEM_OUT,), dev)
    out = torch.empty((N, STEM_OUT, Hp, Wp), dtype=torch.int8, device=dev,
                      memory_format=torch.channels_last)
    _kernels.launch("stem_fused", dev, x.data_ptr(), weight.data_ptr(),
                    bias.data_ptr(), factors.data_ptr(), out.data_ptr(),
                    N, H, W, Hp, Wp, float(scale))
    return out
