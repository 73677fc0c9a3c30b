"""BSR (Block Sparse Row) matrices in numpy: dense <-> block-sparse.

A copy of ``resnet_accel_tpu/sparse/bsr.py`` (``BSRMatrix``,
``build_bsr``, ``build_bsr_int8_direct``, ``conv_weight_to_2d``) and of
the two helpers it takes from ``resnet_accel_tpu/config.py``, kept here
so the port imports nothing of the JAX package.  The tests hold each copy equal to its
original.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

#: The reference hardware's block edge (14 x 14 int8 blocks).
REF_BLOCK: int = 14


def round_up(x: int, m: int) -> int:
    """Round ``x`` up to the next multiple of ``m``."""
    return -(-x // m) * m


@dataclasses.dataclass
class BSRMatrix:
    """A block-sparse matrix: only nonzero ``block_h x block_w`` blocks
    stored.

    ``data[i]`` is the i-th nonzero block; blocks are in CSR order
    (row-major over block rows, ascending column within each row).
    ``row_ptr`` has ``num_block_rows + 1`` entries; blocks of block row
    ``br`` live at indices ``row_ptr[br]:row_ptr[br+1]``.

    ``shape`` is the original (unpadded) dense shape; ``padded_shape`` is
    after alignment to the block grid.  Padding is zeros, so padded
    regions never contribute to a matmul.
    """

    data: np.ndarray          # [nnz, block_h, block_w], int8 or float32
    row_ptr: np.ndarray       # [num_block_rows + 1], int32
    col_idx: np.ndarray       # [nnz], int32
    shape: Tuple[int, int]
    block_h: int
    block_w: int

    @property
    def nnz_blocks(self) -> int:
        return int(self.data.shape[0])

    @property
    def padded_shape(self) -> Tuple[int, int]:
        return (round_up(self.shape[0], self.block_h),
                round_up(self.shape[1], self.block_w))

    @property
    def num_block_rows(self) -> int:
        return self.padded_shape[0] // self.block_h

    @property
    def num_block_cols(self) -> int:
        return self.padded_shape[1] // self.block_w

    @property
    def total_blocks(self) -> int:
        return self.num_block_rows * self.num_block_cols

    @property
    def density(self) -> float:
        t = self.total_blocks
        return self.nnz_blocks / t if t else 0.0

    @property
    def sparsity_pct(self) -> float:
        return (1.0 - self.density) * 100.0

    @property
    def tiles_per_row(self) -> np.ndarray:
        return np.diff(self.row_ptr)

    def compression_ratio(self) -> float:
        """Dense bytes / BSR bytes, metadata included."""
        dense = self.padded_shape[0] * self.padded_shape[1]
        packed = (self.data.size * self.data.itemsize
                  + self.row_ptr.size * 4 + self.col_idx.size * 4)
        return dense / packed if packed else 0.0

    def validate(self) -> None:
        """Raise unless the CSR structure is well formed."""
        if self.row_ptr[0] != 0:
            raise ValueError("row_ptr must start at 0")
        if self.row_ptr[-1] != self.nnz_blocks:
            raise ValueError("row_ptr[-1] must equal nnz_blocks")
        if np.any(np.diff(self.row_ptr) < 0):
            raise ValueError("row_ptr must be non-decreasing")
        if len(self.row_ptr) != self.num_block_rows + 1:
            raise ValueError("row_ptr length mismatch")
        if self.col_idx.size and (
            self.col_idx.min() < 0 or self.col_idx.max() >= self.num_block_cols
        ):
            raise ValueError("col_idx out of range")
        for br in range(self.num_block_rows):
            cols = self.col_idx[self.row_ptr[br]:self.row_ptr[br + 1]]
            if cols.size > 1 and np.any(np.diff(cols) <= 0):
                raise ValueError(f"col_idx not strictly ascending in row {br}")

    def to_dense(self, padded: bool = False) -> np.ndarray:
        """Reconstruct the dense matrix (unpadded by default)."""
        ph, pw = self.padded_shape
        out = np.zeros((ph, pw), dtype=self.data.dtype)
        for br in range(self.num_block_rows):
            for idx in range(int(self.row_ptr[br]), int(self.row_ptr[br + 1])):
                bc = int(self.col_idx[idx])
                out[br * self.block_h:(br + 1) * self.block_h,
                    bc * self.block_w:(bc + 1) * self.block_w] = self.data[idx]
        if padded:
            return out
        return out[:self.shape[0], :self.shape[1]]


def build_bsr(
    weight: np.ndarray,
    block_h: int = REF_BLOCK,
    block_w: Optional[int] = None,
    threshold: float = 1e-10,
    quantize: bool = False,
    scales: Optional[np.ndarray] = None,
) -> BSRMatrix:
    """Convert a dense weight matrix to BSR, dropping (near-)zero blocks:
    zero-pad to the block grid, keep blocks whose L2 norm exceeds
    ``threshold`` and, with ``quantize``, round each kept block to int8
    per global output row with ``scales`` (rows past the original height
    or the scale vector take ``scales[0]``)."""
    weight = np.asarray(weight)
    if weight.ndim != 2:
        raise ValueError(f"expected 2-D weight, got shape {weight.shape}")
    if block_w is None:
        block_w = block_h
    height, width = weight.shape

    pad_h = -height % block_h
    pad_w = -width % block_w
    if pad_h or pad_w:
        weight = np.pad(weight, ((0, pad_h), (0, pad_w)))
    nbr = weight.shape[0] // block_h
    nbc = weight.shape[1] // block_w

    if quantize and scales is None:
        raise ValueError("scales required when quantize=True")

    tiled = weight.reshape(nbr, block_h, nbc, block_w)
    norms = np.sqrt(
        (tiled.astype(np.float64) ** 2).sum(axis=(1, 3))
    )  # [nbr, nbc]
    keep = norms > threshold

    data_list, col_list, row_ptr = [], [], [0]
    for br in range(nbr):
        cols = np.nonzero(keep[br])[0]
        for bc in cols:
            block = tiled[br, :, bc, :]
            if quantize:
                block_i8 = np.empty((block_h, block_w), dtype=np.int8)
                for lr in range(block_h):
                    g = br * block_h + lr
                    if g < height and g < len(scales):
                        s = scales[g]
                    elif len(scales) > 0:
                        s = scales[0]
                    else:
                        s = 1.0
                    block_i8[lr] = np.clip(
                        np.rint(block[lr] / s), -128, 127
                    ).astype(np.int8)
                data_list.append(block_i8)
            else:
                data_list.append(np.array(block, dtype=weight.dtype))
            col_list.append(int(bc))
        row_ptr.append(len(data_list))

    if data_list:
        data = np.stack(data_list)
    else:
        dtype = np.int8 if quantize else weight.dtype
        data = np.zeros((0, block_h, block_w), dtype=dtype)

    return BSRMatrix(
        data=data,
        row_ptr=np.asarray(row_ptr, dtype=np.int32),
        col_idx=np.asarray(col_list, dtype=np.int32),
        shape=(height, width),
        block_h=block_h,
        block_w=block_w,
    )


def build_bsr_int8_direct(
    weight_int8: np.ndarray,
    block_h: int = REF_BLOCK,
    block_w: Optional[int] = None,
) -> BSRMatrix:
    """BSR of an already-quantized int8 weight matrix: a block is dropped
    when all its elements are zero."""
    weight_int8 = np.asarray(weight_int8, dtype=np.int8)
    return build_bsr(weight_int8, block_h, block_w, threshold=0.0)


def conv_weight_to_2d(weight: np.ndarray) -> np.ndarray:
    """Flatten a conv weight [O, I, kH, kW] to [O, I*kH*kW] for BSR and
    the GEMM (export_bsr_14x14.py:556-558; the golden im2col's K order)."""
    weight = np.asarray(weight)
    if weight.ndim != 4:
        raise ValueError(f"expected 4-D conv weight, got {weight.shape}")
    return weight.reshape(weight.shape[0], -1)
