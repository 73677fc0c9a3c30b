"""Int8 pooling in PyTorch, bit-exact with the numpy goldens.

Counterpart of ``resnet_accel_tpu/ops/pooling.py``: the window max pads
with -128 so padding never wins, and the global average rounds as the
golden does, ``(sum + HW/2) / HW`` with C's truncating division.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def maxpool2d_int8(
    x: torch.Tensor, pool_size: int, stride: int, padding: int = 0
) -> torch.Tensor:
    """[N, C, H, W] int8 -> window max, int8."""
    if padding > 0:
        x = F.pad(x, (padding,) * 4, value=-128)
    H, W = x.shape[-2:]
    H_out = (H - pool_size) // stride + 1
    W_out = (W - pool_size) // stride + 1
    out = None
    for ph in range(pool_size):
        for pw in range(pool_size):
            win = x[..., ph:ph + stride * H_out:stride,
                    pw:pw + stride * W_out:stride]
            out = win if out is None else torch.maximum(out, win)
    return out


def avgpool_global_int8(x: torch.Tensor) -> torch.Tensor:
    """[N, C, H, W] int8 -> [N, C] int8 with the golden rounding."""
    hw = x.shape[-2] * x.shape[-1]
    s = x.sum(dim=(2, 3), dtype=torch.int64) + hw // 2
    avg = torch.div(s, hw, rounding_mode="trunc")
    return avg.clamp(-128, 127).to(torch.int8)
