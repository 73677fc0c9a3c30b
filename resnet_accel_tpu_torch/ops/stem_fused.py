"""The fused ImageNet stem: kernel K1 and its plain version.

Counterpart of ``resnet_accel_tpu/ops/stem_fused.py`` (``stem_conv_pool_nm``).
``stem_conv_pool`` launches the CUDA kernel ``csrc/stem_fused.cu`` for CUDA
tensors and runs :func:`stem_conv_pool_plain` for CPU tensors.  Both map
fp32 images [N, 3, H, W] to int8 [N, 64, H', W'] as

    quantize_input(x, scale) -> 7x7/s2/p3 conv + bias + ReLU + requant
                             -> 3x3/s2/p1 max pool

The kernel runs the conv on the int8 tensor cores as the TPU kernel runs
it on the MXU: regrouped by space-to-depth into a 4x4 conv over 12
channels, K = 192 bytes an output.  Its weight is
:func:`pack_stem_weight`'s [64, 192] form, packed once a model
(``ResNet18Int8Module``); both functions here take it or the plain
[64, 3, 7, 7] OIHW weight.  The kernel pools the int32 accumulators and
requantizes once, which commutes with the order above (the requant is
monotone).  Its output is channels-last in memory, the layout the conv
kernel reads.
"""

from __future__ import annotations

from typing import Tuple

import torch

from resnet_accel_tpu_torch import _kernels
from resnet_accel_tpu_torch.ops.conv import conv2d_int8_plain
from resnet_accel_tpu_torch.ops.epilogue import quantize_input
from resnet_accel_tpu_torch.ops.pooling import maxpool2d_int8

STEM_OUT = 64
#: K bytes of an output in the kernel's GEMM: 16 taps x 12 s2d channels.
STEM_K = 192
#: The tensor-core tile of K1 and pooled K10, in pooled outputs (rows,
#: cols): 15 x 17 = 255 conv positions, 16 m16 tiles
#: (``csrc/stem_mma_tile.cuh``).
STEM_TILE = (7, 8)
#: Unpooled K10's tile, in conv outputs: 256 positions, no pad row.
STEM_CONV_TILE = (16, 16)
#: Persistent CTAs an SM (the tile's ``kCtasPerSm``: its 128 registers a
#: thread, and K1's 80 KB of shared memory, fit two).
STEM_CTAS_PER_SM = 2


def stem_conv_hw(H: int, W: int):
    """Output size of the 7x7/s2/p3 conv."""
    return (H - 1) // 2 + 1, (W - 1) // 2 + 1


def stem_out_hw(H: int, W: int):
    """Pooled output size of the 7x7/s2/p3 conv + 3x3/s2/p1 pool."""
    hc, wc = stem_conv_hw(H, W)
    return (hc - 1) // 2 + 1, (wc - 1) // 2 + 1


def stem_plan(N: int, H: int, W: int, sms: int = _kernels.H100_SMS,
              pool: bool = True) -> Tuple[int, int]:
    """(tiles, CTAs) of one K1 call, or K10 call with ``pool``: the (image,
    tile) list the persistent CTAs walk (:data:`STEM_TILE` of the pooled
    output, or :data:`STEM_CONV_TILE` of the conv's), and its grid,
    :data:`STEM_CTAS_PER_SM` an SM of ``sms`` at most."""
    Ho, Wo = stem_out_hw(H, W) if pool else stem_conv_hw(H, W)
    th, tw = STEM_TILE if pool else STEM_CONV_TILE
    tiles = N * (-(-Ho // th)) * (-(-Wo // tw))
    return tiles, min(tiles, STEM_CTAS_PER_SM * sms)


def pack_stem_weight(weight: torch.Tensor) -> torch.Tensor:
    """[64, 3, 7, 7] int8 OIHW -> [64, 192] int8, the kernel's B operand:
    the taps zero-padded at the front to 8 x 8 and regrouped as
    ``ops.conv.stem_s2d_weights`` does, each channel's bytes in the order
    k = (kh2 * 4 + kw2) * 12 + c * 4 + rp * 2 + cp, the K order of the
    kernel's A rows (tap-major, then the s2d channel)."""
    O = weight.shape[0]
    w8 = torch.zeros((O, 3, 8, 8), dtype=torch.int8, device=weight.device)
    w8[:, :, 1:, 1:] = weight.reshape(O, 3, 7, 7)
    w = w8.reshape(O, 3, 4, 2, 4, 2).permute(0, 2, 4, 1, 3, 5)
    return w.reshape(O, STEM_K).contiguous()


def unpack_stem_weight(packed: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`pack_stem_weight`: [64, 192] -> [64, 3, 7, 7]."""
    O = packed.shape[0]
    w = packed.reshape(O, 4, 4, 3, 2, 2).permute(0, 3, 1, 4, 2, 5)
    return w.reshape(O, 3, 8, 8)[:, :, 1:, 1:].contiguous()


def stem_oihw(weight: torch.Tensor) -> torch.Tensor:
    """The OIHW [64, 3, 7, 7] form of either weight the stem takes."""
    return unpack_stem_weight(weight) if weight.dim() == 2 else weight


def stem_packed(weight: torch.Tensor, device: torch.device) -> torch.Tensor:
    """The kernels' [64, 192] B operand on ``device``, checked: the packed
    weight as it is, or the OIHW [64, 3, 7, 7] one packed here."""
    if weight.dim() == 4:
        _kernels.check(weight, "weight", torch.int8, (STEM_OUT, 3, 7, 7),
                       device)
        weight = pack_stem_weight(weight)
    _kernels.check(weight, "weight", torch.int8, (STEM_OUT, STEM_K), device)
    return weight


def stem_conv_pool_plain(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    factors: torch.Tensor,
    scale: float,
) -> torch.Tensor:
    """Plain PyTorch version: the golden composition.  ``weight`` as
    :func:`stem_conv_pool` takes it."""
    a = quantize_input(x, scale)
    a = conv2d_int8_plain(a, stem_oihw(weight), bias, factors, stride=2,
                          padding=3, relu=True)
    return maxpool2d_int8(a, 3, 2, padding=1)


def stem_conv_pool(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    factors: torch.Tensor,
    scale: float,
) -> torch.Tensor:
    """``x`` [N, 3, H, W] fp32, ``weight`` [64, 3, 7, 7] int8 (packed on
    each call) or :func:`pack_stem_weight`'s [64, 192], ``bias`` [64]
    int32, ``factors`` [64] float32, ``scale`` the input quantization
    scale -> [N, 64, H', W'] int8."""
    if x.device.type == "cpu":
        return stem_conv_pool_plain(x, weight, bias, factors, scale)
    if x.device.type != "cuda":
        raise ValueError(f"stem_conv_pool: unsupported device {x.device}")
    N, _, H, W = x.shape
    Hp, Wp = stem_out_hw(H, W)
    dev = x.device
    _kernels.check(x, "x", torch.float32, (N, 3, H, W), dev)
    weight = stem_packed(weight, dev)
    _kernels.check(bias, "bias", torch.int32, (STEM_OUT,), dev)
    _kernels.check(factors, "factors", torch.float32, (STEM_OUT,), dev)
    out = torch.empty((N, STEM_OUT, Hp, Wp), dtype=torch.int8, device=dev,
                      memory_format=torch.channels_last)
    tiles, ctas = stem_plan(N, H, W, _kernels.sm_count(dev))
    if tiles == 0:
        return out
    _kernels.launch("stem_fused", dev, x.data_ptr(), weight.data_ptr(),
                    bias.data_ptr(), factors.data_ptr(), out.data_ptr(),
                    N, H, W, Hp, Wp, ctas, float(scale))
    return out
