"""Dense int8 GEMM with a fused epilogue: kernel K3 and its plain version.

Counterpart of ``resnet_accel_tpu/ops/matmul_int8.py``.  ``matmul_int8``
launches the CUDA kernel ``csrc/matmul_int8.cu`` for CUDA tensors and runs
:func:`matmul_int8_plain` for CPU tensors; it never moves data between the
two.  Both compute

    acc = A[M, K] @ B[K, N]  (int8 x int8 -> int32) + bias
    acc = relu(acc)                       if relu
    out = clip(rint(acc * factors))       if factors is given, else acc

The kernel takes the weight K-major, as W = B^T [N, K] row-major (the
int8 tensor cores read both operands K-major only).  ``b`` keeps the JAX
signature, logically [K, N]: the ``.t()`` view of a row-major [N, K] goes
to the kernel as it is, and any other ``b`` is transposed once by the
wrapper, one copy.  The serving modules hold their fc weights as such
views, so the served path makes no copy.
"""

from __future__ import annotations

from typing import Optional

import torch

from resnet_accel_tpu_torch import _kernels
from resnet_accel_tpu_torch._kernels import GemmPlan, cluster_split
from resnet_accel_tpu_torch.ops.epilogue import requantize


def matmul_int8_plain(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    bias: Optional[torch.Tensor] = None,
    factors: Optional[torch.Tensor] = None,
    relu: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version, for ``b`` in any layout.  The product runs in
    float64, which is exact here: every product is an integer of at most
    2^14 and every partial sum stays far below 2^53, so it gives the same
    bits on any device."""
    acc = torch.matmul(a.to(torch.float64), b.to(torch.float64))
    acc = acc.to(torch.int32)
    if factors is not None:
        return requantize(acc, factors, relu=relu, bias=bias)
    if bias is not None:
        acc = acc + bias.to(torch.int32)
    if relu:
        acc = acc.clamp_min(0)
    return acc


#: K3's N tile (columns a CTA) and K tile (bytes a stage): the kernel's.
BN, BK = 64, 128


def weight_nk(b: torch.Tensor) -> torch.Tensor:
    """``b`` [K, N] as the K-major weight W [N, K] the kernel takes:
    ``b.t()`` itself where that is row-major (``b`` is the ``.t()`` view of
    a row-major [N, K]), else a transposed copy."""
    w = b.t()
    return w if w.is_contiguous() else w.contiguous()


def matmul_plan(a: torch.Tensor, w: torch.Tensor,
                sms: int = _kernels.H100_SMS) -> GemmPlan:
    """K3's path for ``a`` [M, K] and W [N, K]: TMA where it takes both
    operands (K % 16 == 0, 16-byte aligned bases; ``wgmma_tma``), else the
    staged loads (``wgmma_ld``); K split across a cluster of two while
    the grid of 128 x 64 tiles leaves half the card's ``sms`` SMs idle."""
    M, K = a.shape
    tma = K > 0 and K % 16 == 0 and a.data_ptr() % 16 == 0 \
        and w.data_ptr() % 16 == 0
    ctas = -(-M // 128) * -(-w.shape[0] // BN)
    return GemmPlan("wgmma_tma" if tma else "wgmma_ld", BN,
                    cluster_split(ctas, -(-K // BK), sms))


def matmul_int8(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    bias: Optional[torch.Tensor] = None,
    factors: Optional[torch.Tensor] = None,
    relu: bool = False,
) -> torch.Tensor:
    """int8 ``a`` [M, K] @ int8 ``b`` [K, N] with optional int32 ``bias``
    [N], ReLU and float32 requant ``factors`` [N].  Returns int8 [M, N]
    when ``factors`` is given, else int32 [M, N].  On a card ``b`` is best
    the ``.t()`` view of a row-major [N, K]; any other layout costs one
    transposed copy (see :func:`weight_nk`)."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"shape mismatch: A{tuple(a.shape)} "
                         f"B{tuple(b.shape)}")
    if a.device.type == "cpu":
        return matmul_int8_plain(a, b, bias=bias, factors=factors, relu=relu)
    if a.device.type != "cuda":
        raise ValueError(f"matmul_int8: unsupported device {a.device}")
    M, K = a.shape
    N = b.shape[1]
    dev = a.device
    _kernels.check(a, "a", torch.int8, (M, K), dev)
    w = weight_nk(b)
    _kernels.check(w, "b.t()", torch.int8, (N, K), dev)
    if bias is not None:
        _kernels.check(bias, "bias", torch.int32, (N,), dev)
    if factors is not None:
        _kernels.check(factors, "factors", torch.float32, (N,), dev)
    out = torch.empty((M, N), device=dev,
                      dtype=torch.int8 if factors is not None
                      else torch.int32)
    if M == 0 or N == 0:
        return out
    plan = matmul_plan(a, w, _kernels.sm_count(dev))
    _kernels.launch(
        "matmul_int8", dev, a.data_ptr(), w.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if factors is None else factors.data_ptr(),
        out.data_ptr(), M, N, K, int(relu), int(factors is not None),
        int(plan.variant == "wgmma_tma"), plan.split, variant=plan.variant)
    return out
