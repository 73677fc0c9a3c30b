"""A bottleneck block's 1x1 expand conv with its residual join, in one
pass: kernel K7 and its plain version.

Counterpart of ``resnet_accel_tpu/ops/expand_fused.py``.
``expand_add_int8`` launches the CUDA kernel ``csrc/expand_add.cu`` for
CUDA tensors and runs :func:`expand_add_int8_plain` for CPU tensors.  Both
compute, per pixel p and output channel o,

    acc = sum_c x[p, c] * w[o, c] + bias[o]                  (int32)
    y   = clip(rint(float32(acc) * factors[o]), -128, 127)   (no ReLU)
    out = max(clip(rint((y*s_main + r*s_res) / s_out), -128, 127), 0)

which is ``conv2d_int8`` at kernel 1 without ReLU followed by
``add_residual(..., relu=True)``.  The join always divides by ``s_out``,
as the golden does; the JAX package's reciprocal multiply, taken only
under ``exact_inv_out_scale``'s proof, gives the same bits.

Tensors are NCHW at this interface.  ``x`` and ``residual`` are read, and
the output written, in ``torch.channels_last`` memory order, as K2 takes
them.  The TPU kernel's batch-minor view and its batch-of-128 gate are not
ported: any batch runs.
"""

from __future__ import annotations

import torch

from resnet_accel_tpu_torch import _kernels
from resnet_accel_tpu_torch.ops.epilogue import add_residual, requantize
from resnet_accel_tpu_torch.ops.matmul_int8 import matmul_int8_plain


def expand_add_int8_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor,
    factors: torch.Tensor,
    residual: torch.Tensor,
    s_main: float,
    s_res: float,
    s_out: float,
) -> torch.Tensor:
    """Plain PyTorch version: the 1x1 conv as the float64 product of
    :func:`matmul_int8_plain` (exact), ``requantize`` without ReLU, then
    ``add_residual`` with its ReLU."""
    N, C, H, W = x.shape
    O = w.shape[0]
    acc = matmul_int8_plain(x.permute(0, 2, 3, 1).reshape(-1, C), w.t())
    acc = acc.reshape(N, H, W, O).permute(0, 3, 1, 2)
    y = requantize(acc, factors, relu=False, bias=bias, axis=1)
    out = add_residual(y, residual, s_main, s_res, s_out, relu=True)
    return out.contiguous(memory_format=torch.channels_last)


def expand_add_int8(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor,
    factors: torch.Tensor,
    residual: torch.Tensor,
    s_main: float,
    s_res: float,
    s_out: float,
) -> torch.Tensor:
    """``x`` [N, C_in, H, W] int8, ``w`` [C_out, C_in] int8 (K-contiguous
    rows), ``bias`` [C_out] int32, ``factors`` [C_out] float32 and
    ``residual`` [N, C_out, H, W] int8 -> [N, C_out, H, W] int8, the
    joined block output (module docstring)."""
    if x.device.type == "cpu":
        return expand_add_int8_plain(x, w, bias, factors, residual, s_main,
                                     s_res, s_out)
    if x.device.type != "cuda":
        raise ValueError(f"expand_add_int8: unsupported device {x.device}")
    N, C, H, W = x.shape
    O = w.shape[0]
    if C % 4 or O % 4:
        raise ValueError(f"expand_add_int8 kernel needs C_in and C_out "
                         f"divisible by 4, got C_in={C} C_out={O}")
    dev = x.device
    cl = torch.channels_last
    _kernels.check(x, "x", torch.int8, (N, C, H, W), dev, cl)
    _kernels.check(w, "w", torch.int8, (O, C), dev)
    _kernels.check(bias, "bias", torch.int32, (O,), dev)
    _kernels.check(factors, "factors", torch.float32, (O,), dev)
    _kernels.check(residual, "residual", torch.int8, (N, O, H, W), dev, cl)
    for name, t in (("x", x), ("w", w), ("residual", residual)):
        if t.data_ptr() % 4:
            raise ValueError(f"expand_add_int8: {name} is not 4-byte "
                             f"aligned")
    out = torch.empty((N, O, H, W), dtype=torch.int8, device=dev,
                      memory_format=cl)
    if out.numel() == 0:     # an empty grid is not a launch
        return out
    _kernels.launch(
        "expand_add", dev, x.data_ptr(), w.data_ptr(), bias.data_ptr(),
        factors.data_ptr(), residual.data_ptr(), out.data_ptr(), N * H * W,
        C, O, s_main, s_res, s_out)
    return out
