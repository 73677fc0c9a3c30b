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
``add_residual(..., relu=True)``.  As in the JAX function, ``inv_out``
(``exact_inv_out_scale``'s proof for the scales, or None) replaces the
divide by a multiply by the proven reciprocal: the same bits, checked on
all 256 x 256 int8 pairs; None keeps the golden divide.

The kernel has two routes, chosen from the shapes and pointers alone
(:func:`expand_plan`) and counted by ``_kernels.variant_counts()``:
``wgmma_tma``, the Hopper main loop of ``csrc/sm90_gemm_s8.cuh`` in K7's
mode, where TMA takes the operands (C_in and C_out multiples of 16, the
activations' and the weight's bases 16-byte aligned: each c3 of the
family); ``mma_sync``, a one-pass ``mma.sync`` kernel, for the rest
(C_in and C_out multiples of 4).

Tensors are NCHW at this interface.  ``x`` and ``residual`` are read, and
the output written, in ``torch.channels_last`` memory order, as K2 takes
them.  The TPU kernel's batch-minor view and its batch-of-128 gate are not
ported: any batch runs.
"""

from __future__ import annotations

from typing import Optional

import torch

from resnet_accel_tpu_torch import _kernels
from resnet_accel_tpu_torch._kernels import GemmPlan
from resnet_accel_tpu_torch.ops.epilogue import add_residual, requantize
from resnet_accel_tpu_torch.ops.matmul_int8 import matmul_int8_plain

#: The Hopper route's tile: output pixels (A rows) by output channels.  On
#: the H100 128 channels beat 256 and 64 at every c3 of ResNet-50
#: (PERF.md §6).
BM, BN = 128, 128


def expand_add_int8_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor,
    factors: torch.Tensor,
    residual: torch.Tensor,
    s_main: float,
    s_res: float,
    s_out: float,
    inv_out: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch version: the 1x1 conv as the float64 product of
    :func:`matmul_int8_plain` (exact), ``requantize`` without ReLU, then
    ``add_residual`` with its ReLU (and ``inv_out`` as its
    ``inv_out_scale``)."""
    N, C, H, W = x.shape
    O = w.shape[0]
    acc = matmul_int8_plain(x.permute(0, 2, 3, 1).reshape(-1, C), w.t())
    acc = acc.reshape(N, H, W, O).permute(0, 3, 1, 2)
    y = requantize(acc, factors, relu=False, bias=bias, axis=1)
    out = add_residual(y, residual, s_main, s_res, s_out, relu=True,
                       inv_out_scale=inv_out)
    return out.contiguous(memory_format=torch.channels_last)


def expand_plan(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                factors: torch.Tensor, residual: torch.Tensor) -> GemmPlan:
    """K7's route for the tensors :func:`expand_add_int8` takes:
    ``wgmma_tma`` (N tile :data:`BN`) where TMA takes the
    operands (C and O multiples of 16, ``x``, ``w`` and ``residual``
    16-byte aligned, as the output the wrapper allocates is) and the
    epilogue its 8-byte loads of ``bias`` and ``factors`` (8-byte
    aligned), else ``mma_sync`` (N tile 0)."""
    C, O = x.shape[1], w.shape[0]
    tma = C % 16 == 0 and O % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (x, w, residual)) and all(
        t.data_ptr() % 8 == 0 for t in (bias, factors))
    if not tma:
        return GemmPlan("mma_sync", 0, 1)
    return GemmPlan("wgmma_tma", BN, 1)


def expand_add_int8(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor,
    factors: torch.Tensor,
    residual: torch.Tensor,
    s_main: float,
    s_res: float,
    s_out: float,
    inv_out: Optional[float] = None,
) -> torch.Tensor:
    """``x`` [N, C_in, H, W] int8, ``w`` [C_out, C_in] int8 (K-contiguous
    rows), ``bias`` [C_out] int32, ``factors`` [C_out] float32 and
    ``residual`` [N, C_out, H, W] int8 -> [N, C_out, H, W] int8, the
    joined block output (module docstring); ``inv_out``: the proven
    reciprocal of ``s_out`` or None."""
    if x.device.type == "cpu":
        return expand_add_int8_plain(x, w, bias, factors, residual, s_main,
                                     s_res, s_out, inv_out)
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
    plan = expand_plan(x, w, bias, factors, residual)
    _kernels.launch(
        "expand_add", dev, x.data_ptr(), w.data_ptr(), bias.data_ptr(),
        factors.data_ptr(), residual.data_ptr(), out.data_ptr(), N * H * W,
        C, O, plan.bn, int(inv_out is not None), s_main, s_res, s_out,
        0.0 if inv_out is None else inv_out, variant=plan.variant)
    return out
