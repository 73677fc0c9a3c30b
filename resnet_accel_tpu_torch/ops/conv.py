"""Int8 convolution with a fused epilogue and an optional fused residual
join: kernel K2 and its plain version.

Counterpart of ``resnet_accel_tpu/ops/conv.py`` (``conv2d_int8``,
``im2col_nchw``, ``space_to_depth_nchw``, ``stem_s2d_weights``) and of the
residual-join convs of
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

The kernel has two paths, chosen by shape alone (:func:`conv_plan`) and
counted by ``_kernels.variant_counts()``: ``wgmma_tma``, the Hopper main
loop (``csrc/sm90_gemm_s8.cuh``) with A read through a TMA map in im2col
mode, where C % 32 == 0 (every trunk conv); ``mma_sync`` for the rest (the
space-to-depth stem's 4x4 conv at C = 12, the MNIST conv1).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from resnet_accel_tpu_torch import _kernels
from resnet_accel_tpu_torch.ops.epilogue import add_residual, requantize
from resnet_accel_tpu_torch.ops.matmul_int8 import matmul_int8_plain


#: A conv's zero padding: one int for every side, or JAX's per-side
#: ``((top, bottom), (left, right))``.
Padding = Union[int, Tuple[Tuple[int, int], Tuple[int, int]]]


def _pads(padding: Padding) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    if isinstance(padding, int):
        return (padding, padding), (padding, padding)
    (t, b), (l, r) = padding
    return (int(t), int(b)), (int(l), int(r))


def im2col_nchw(
    x: torch.Tensor, kernel: int, stride: int, padding: Padding
) -> torch.Tensor:
    """[N, C, H, W] -> [N, H_out*W_out, C*K*K] patches, row order
    (c, kh, kw) as in the golden ``im2col_int8``; zero padding."""
    N, C, H, W = x.shape
    K = kernel
    H_out, W_out = _out_hw(H, W, K, stride, padding)
    (t, b), (l, r) = _pads(padding)
    if t or b or l or r:
        x = F.pad(x, (l, r, t, b))
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
            padding: Padding) -> Tuple[int, int]:
    (t, b), (l, r) = _pads(padding)
    return ((H + t + b - kernel) // stride + 1,
            (W + l + r - kernel) // stride + 1)


def space_to_depth_nchw(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """[N, C, H, W] -> [N, C*block^2, H/block, W/block], channel order
    (c, row-parity, col-parity), the order :func:`stem_s2d_weights`
    pairs with (``F.pixel_unshuffle``'s)."""
    N, C, H, W = x.shape
    x = x.reshape(N, C, H // block, block, W // block, block)
    x = x.permute(0, 1, 3, 5, 2, 4)
    return x.reshape(N, C * block * block, H // block, W // block)


def stem_s2d_weights(weight2d: np.ndarray, in_c: int,
                     kernel: int) -> np.ndarray:
    """Space-to-depth form of a (kernel, stride 2, pad kernel // 2) conv
    weight, exact in int8: [O, C*k*k] -> [O, 4C*((k+1)/2)^2].

    The k x k taps are zero-padded at the front to (k+1) x (k+1) and
    regrouped by (row, col) parity into a ((k+1)/2)^2-tap conv over
    :func:`space_to_depth_nchw` of the input, with padding
    ``((p+1)//2, (p-1)//2)`` per side where p = kernel // 2: for the 7x7
    stem a 4x4 stride-1 conv padded ((2, 1), (2, 1)).  Every product of
    the original conv is kept and the added taps meet structural zeros,
    so the int32 sums are identical."""
    if kernel % 2 == 0:
        raise ValueError("stem_s2d_weights expects an odd kernel")
    O = weight2d.shape[0]
    w4 = np.asarray(weight2d).reshape(O, in_c, kernel, kernel)
    w8 = np.pad(w4, ((0, 0), (0, 0), (1, 0), (1, 0)))
    k2 = (kernel + 1) // 2
    w = w8.reshape(O, in_c, k2, 2, k2, 2).transpose(0, 1, 3, 5, 2, 4)
    return np.ascontiguousarray(w.reshape(O, -1))


def conv_plan(C: int) -> str:
    """K2's path for ``C`` input channels: ``wgmma_tma`` where a K stage
    can be one tap's 32, 64 or 128 channel bytes (C % 32 == 0), else
    ``mma_sync``."""
    return "wgmma_tma" if C % 32 == 0 else "mma_sync"


def conv_tile_n(O: int, K: int) -> int:
    """The Hopper path's N tile (output channels a CTA) for O outputs and K
    = kernel * kernel * C bytes a window: 128 where the walk is long (K >=
    2048) and O >= 512, else 64.  On the H100 a 64-wide tile leaves through
    a TMA store, cheaper than the 128-wide tile's fragment stores, and wins
    wherever the epilogue weighs as much as the main loop: every trunk conv
    but the long 3x3s of stage 4 and ResNet-50's 1x1 from 2048 channels
    (``kernel_ab.py --k2-tiles``; PERF.md §6)."""
    return 128 if K >= 2048 and O >= 512 else 64


def conv2d_int8_plain(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    factors: torch.Tensor,
    *,
    stride: int = 1,
    padding: Padding = 0,
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
    padding: Padding = 0,
    relu: bool = False,
    residual: Optional[torch.Tensor] = None,
    res_scales: Optional[Tuple[float, float, float]] = None,
) -> torch.Tensor:
    """Fused int8 conv: ``x`` [N, C, H, W] int8, ``weight`` [O, C, K, K]
    int8, ``bias`` [O] int32, ``factors`` [O] float32 -> [N, O, Ho, Wo]
    int8; ``padding`` an int or ``((top, bottom), (left, right))``.
    With ``residual`` [N, O, Ho, Wo] int8 and ``res_scales`` = (s_main,
    s_res, s_out) the output is the basic block's residual join (with its
    ReLU) instead of the requantized conv."""
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
    path = conv_plan(C)
    H_out, W_out = _out_hw(H, W, K, stride, padding)
    pads = _pads(padding)
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
        N, H, W, C, O, H_out, W_out, K, stride, pads[0][0], pads[1][0],
        int(relu), 0 if path == "mma_sync" else conv_tile_n(O, K * K * C),
        s_main, s_res, s_out,
        variant=path)
    return out
