"""INT8 block-sparse projections of the transformer family.

Counterpart of ``SparseProjection`` in ``resnet_accel_tpu/models/attention.py``.
A projection W[d_out, d_in] is per-channel INT8 in BSR form; it maps int8
activations with one float32 scale to float32:

    acc = x_int8 @ W^T                          (int8 x int8 -> int32)
    out = float32(acc) * (float32(x_scale) * scales) + bias

``SparseProjection`` holds the numpy data and the golden; ``to(device)``
gives a :class:`PackedProjection` whose ``project`` runs the gather-compact
BSR product (``bsr_matmul_wt_xla``) on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from resnet_accel_tpu_torch import golden
from resnet_accel_tpu_torch.ops.bsr_matmul import (
    GatherBSR,
    bsr_matmul_wt_xla,
    pack_gather_bsr,
)
from resnet_accel_tpu_torch.sparse.bsr import BSRMatrix


@dataclasses.dataclass
class SparseProjection:
    """One INT8 block-sparse projection W[d_out, d_in] (numpy)."""

    bsr: BSRMatrix
    scales: np.ndarray          # [d_out] float32 per-channel weight scales
    bias: Optional[np.ndarray]  # [d_out] float32

    @property
    def d_out(self) -> int:
        return self.bsr.shape[0]

    @property
    def d_in(self) -> int:
        return self.bsr.shape[1]

    def project_golden(self, x_int8: np.ndarray,
                       x_scale: float) -> np.ndarray:
        acc = golden.bsr_matmul_int8_wt(
            x_int8, self.bsr.data, self.bsr.row_ptr, self.bsr.col_idx,
            self.bsr.block_h, self.bsr.block_w, N=self.d_out)
        out = acc.astype(np.float32) * (
            np.float32(x_scale) * self.scales[None, :])
        if self.bias is not None:
            out = out + self.bias[None, :]
        return out

    def to(self, device) -> "PackedProjection":
        return PackedProjection(
            gather=pack_gather_bsr(self.bsr, device),
            scales=torch.from_numpy(
                np.asarray(self.scales, np.float32)).to(device),
            bias=None if self.bias is None else torch.from_numpy(
                np.asarray(self.bias, np.float32)).to(device))


@dataclasses.dataclass
class PackedProjection:
    """A :class:`SparseProjection` on a device."""

    gather: GatherBSR
    scales: torch.Tensor            # [d_out] float32
    bias: Optional[torch.Tensor]    # [d_out] float32

    def project(self, x_int8: torch.Tensor,
                x_scale: torch.Tensor) -> torch.Tensor:
        """[..., d_in] int8 -> [..., d_out] float32.  ``x_scale`` is a
        float32 tensor that broadcasts against the output (one element, or
        one per sequence, shaped [..., 1, 1])."""
        lead = x_int8.shape[:-1]
        acc = bsr_matmul_wt_xla(x_int8.reshape(-1, x_int8.shape[-1]),
                                self.gather).reshape(*lead, -1)
        out = acc.to(torch.float32) * (x_scale * self.scales)
        if self.bias is not None:
            out = out + self.bias
        return out
