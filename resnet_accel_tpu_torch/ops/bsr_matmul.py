"""Block-sparse int8 GEMM that visits stored blocks only (the zero-block
skip): kernel K4 and its plain version.

Counterpart of ``resnet_accel_tpu/ops/bsr_matmul.py``.  The weight W[N, K]
is held in BSR (block rows index output columns, block columns index K)
and both versions compute

    acc = A[M, K] @ W^T over the stored blocks   (int8 x int8 -> int32)
    acc = acc + bias; acc = relu(acc)            if given
    out = clip(rint(float32(acc) * factors))     if factors is given

``bsr_matmul_wt`` launches the CUDA kernel ``csrc/bsr_matmul.cu`` for CUDA
tensors and runs :func:`bsr_matmul_wt_plain` for CPU tensors.  A block row
with no stored block still yields its output columns (``bias`` through the
epilogue), as the TPU kernel's zero filler block does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from resnet_accel_tpu_torch import _kernels
from resnet_accel_tpu_torch.ops.epilogue import requantize
from resnet_accel_tpu_torch.sparse.bsr import BSRMatrix


@dataclasses.dataclass
class PackedBSR:
    """A ``BSRMatrix`` of int8 blocks on a device, in the CSR layout the
    kernel walks: the blocks of block row ``br`` are
    ``blocks[row_ptr[br]:row_ptr[br + 1]]``, each [block_h, block_w] in
    the W[N, K] orientation, at block column ``col_idx[i]``."""

    blocks: torch.Tensor     # [nnz, block_h, block_w] int8
    row_ptr: torch.Tensor    # [n_padded / block_h + 1] int32
    col_idx: torch.Tensor    # [nnz] int32
    block_h: int
    block_w: int
    n_out: int               # N of the unpadded weight
    k_dim: int               # K of the unpadded weight
    n_padded: int
    k_padded: int
    nnz_source: int          # stored blocks
    total_source: int        # blocks of the padded grid


def pack_bsr(bsr: BSRMatrix, device) -> PackedBSR:
    """Upload an int8 ``BSRMatrix`` to ``device`` for :func:`bsr_matmul_wt`."""
    if bsr.data.dtype != np.int8:
        raise ValueError("pack_bsr needs int8 blocks")

    def put(arr, dtype):
        return torch.from_numpy(np.ascontiguousarray(arr, dtype)).to(device)

    return PackedBSR(
        blocks=put(bsr.data, np.int8).reshape(-1, bsr.block_h, bsr.block_w),
        row_ptr=put(bsr.row_ptr, np.int32),
        col_idx=put(bsr.col_idx, np.int32),
        block_h=bsr.block_h, block_w=bsr.block_w,
        n_out=bsr.shape[0], k_dim=bsr.shape[1],
        n_padded=bsr.padded_shape[0], k_padded=bsr.padded_shape[1],
        nnz_source=bsr.nnz_blocks, total_source=bsr.total_blocks)


def _check_k(a: torch.Tensor, packed: PackedBSR) -> None:
    if a.ndim != 2:
        raise ValueError(f"A must be 2-D, got shape {tuple(a.shape)}")
    K = a.shape[1]
    if K not in (packed.k_dim, packed.k_padded):
        raise ValueError(f"A has K={K}, BSR expects {packed.k_dim} "
                         f"(padded {packed.k_padded})")


def bsr_matmul_wt_plain(
    a: torch.Tensor,
    packed: PackedBSR,
    *,
    bias: Optional[torch.Tensor] = None,
    factors: Optional[torch.Tensor] = None,
    relu: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version, the gather-einsum of the JAX
    ``bsr_matmul_wt_xla``: gather the K slab of A each stored block needs,
    contract it with the block, add each product into its block row.  In
    float64, which is exact (see ``matmul_int8_plain``), for any block
    size."""
    _check_k(a, packed)
    M, K = a.shape
    bh, bw = packed.block_h, packed.block_w
    nbr = packed.n_padded // bh
    a64 = F.pad(a.to(torch.float64), (0, packed.k_padded - K))
    slabs = a64.reshape(M, packed.k_padded // bw, bw).index_select(
        1, packed.col_idx.long())                          # [M, nnz, bw]
    part = torch.einsum("mlw,lhw->mlh", slabs,
                        packed.blocks.to(torch.float64))    # [M, nnz, bh]
    row_of = torch.repeat_interleave(
        torch.arange(nbr, device=a.device), packed.row_ptr.diff().long())
    acc = torch.zeros((M, nbr, bh), dtype=torch.float64, device=a.device)
    acc.index_add_(1, row_of, part)
    acc = acc.reshape(M, -1)[:, :packed.n_out].to(torch.int32)
    if factors is not None:
        return requantize(acc, factors, relu=relu, bias=bias)
    if bias is not None:
        acc = acc + bias.to(torch.int32)
    if relu:
        acc = acc.clamp_min(0)
    return acc


def bsr_matmul_wt(
    a: torch.Tensor,
    packed: PackedBSR,
    *,
    bias: Optional[torch.Tensor] = None,
    factors: Optional[torch.Tensor] = None,
    relu: bool = False,
) -> torch.Tensor:
    """Zero-skip C[M, n_out] = A[M, K] @ W^T for int8 ``a`` (K is the
    weight's ``k_dim`` or ``k_padded``), with optional int32 ``bias``
    [n_out], ReLU and float32 requant ``factors`` [n_out].  Returns int8
    when ``factors`` is given, else int32.

    The kernel takes ``block_h % 16 == 0`` and ``block_w % 32 == 0``; on a
    CUDA tensor any other block shape raises."""
    _check_k(a, packed)
    if a.device.type == "cpu":
        return bsr_matmul_wt_plain(a, packed, bias=bias, factors=factors,
                                   relu=relu)
    if a.device.type != "cuda":
        raise ValueError(f"bsr_matmul_wt: unsupported device {a.device}")
    bh, bw = packed.block_h, packed.block_w
    if bh % 16 or bw % 32:
        raise ValueError(f"bsr_matmul kernel needs block_h % 16 == 0 and "
                         f"block_w % 32 == 0, got {bh} x {bw}")
    M, K = a.shape
    N = packed.n_out
    nbr = packed.n_padded // bh
    dev = a.device
    _kernels.check(a, "a", torch.int8, (M, K), dev)
    _kernels.check(packed.blocks, "blocks", torch.int8,
                   (packed.nnz_source, bh, bw), dev)
    _kernels.check(packed.row_ptr, "row_ptr", torch.int32, (nbr + 1,), dev)
    _kernels.check(packed.col_idx, "col_idx", torch.int32,
                   (packed.nnz_source,), dev)
    if bias is not None:
        _kernels.check(bias, "bias", torch.int32, (N,), dev)
    if factors is not None:
        _kernels.check(factors, "factors", torch.float32, (N,), dev)
    out = torch.empty((M, N), device=dev,
                      dtype=torch.int8 if factors is not None
                      else torch.int32)
    if M == 0:
        return out
    # 16-byte loads of A need aligned rows; other A take a byte gather.
    vec_a = K % 16 == 0 and a.data_ptr() % 16 == 0
    _kernels.launch(
        "bsr_matmul", dev, a.data_ptr(), packed.blocks.data_ptr(),
        packed.row_ptr.data_ptr(), packed.col_idx.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if factors is None else factors.data_ptr(), out.data_ptr(),
        M, K, N, nbr, bh, bw, int(relu), int(factors is not None),
        int(vec_a))
    return out
