"""INT8 block-sparse projections and single-head sparse attention.

Counterpart of ``resnet_accel_tpu/models/attention.py``.  A projection
W[d_out, d_in] is per-channel INT8 in BSR form; it maps int8 activations
with one float32 scale to float32:

    acc = x_int8 @ W^T                          (int8 x int8 -> int32)
    out = float32(acc) * (float32(x_scale) * scales) + bias

``SparseProjection`` holds the numpy data and the golden; ``to(device)``
gives a :class:`PackedProjection` whose ``project`` runs the gather-compact
BSR product (``bsr_matmul_wt_xla``) on the device.  The transformer
family's layers use them, and so does :class:`SparseAttentionInt8`, which
runs the fixture tree's Q/K/V projections (``sparse/fixtures.py``) and
softmax(QK^T / sqrt(d)) V over them in float32.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Union

import numpy as np
import torch

from resnet_accel_tpu_torch import golden
from resnet_accel_tpu_torch.ops.bsr_matmul import (
    GatherBSR,
    bsr_matmul_wt_xla,
    pack_gather_bsr,
)
from resnet_accel_tpu_torch.runtime.backend import resolve_device
from resnet_accel_tpu_torch.sparse.bsr import BSRMatrix
from resnet_accel_tpu_torch.sparse.io import (load_layer_dir,
                                              load_layer_scales_bias)


@dataclasses.dataclass
class SparseProjection:
    """One INT8 block-sparse projection W[d_out, d_in] (numpy)."""

    bsr: BSRMatrix
    scales: np.ndarray          # [d_out] float32 per-channel weight scales
    bias: Optional[np.ndarray]  # [d_out] float32

    @classmethod
    def from_fixture_dir(cls, path: str) -> "SparseProjection":
        """A fixture directory (``sparse/fixtures.py``'s layout); its
        ``scales.npy`` is required, ``bias.npy`` optional."""
        bsr = load_layer_dir(path)
        scales, bias = load_layer_scales_bias(path)
        if scales is None:
            raise ValueError(f"{path}: missing scales.npy")
        return cls(bsr=bsr, scales=scales, bias=bias)

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


def projection_from_reference(p) -> SparseProjection:
    """Carry one of the JAX package's ``SparseProjection``s across: its
    BSR ``data``, ``row_ptr``, ``col_idx``, geometry, ``scales`` and
    ``bias`` as numpy; nothing of the JAX module is imported."""
    b = p.bsr
    bsr = BSRMatrix(data=np.asarray(b.data, np.int8),
                    row_ptr=np.asarray(b.row_ptr, np.int32),
                    col_idx=np.asarray(b.col_idx, np.int32),
                    shape=tuple(int(s) for s in b.shape),
                    block_h=int(b.block_h), block_w=int(b.block_w))
    return SparseProjection(
        bsr=bsr, scales=np.asarray(p.scales, np.float32),
        bias=None if p.bias is None else np.asarray(p.bias, np.float32))


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


@dataclasses.dataclass
class SparseAttentionInt8:
    """Single-head attention over INT8 block-sparse Q/K/V projections, on
    ``device`` (the card unless the caller asks for the CPU).

    The input is quantized per tensor, the three projections run as int8
    block-sparse products dequantized per output channel, and
    softmax(QK^T / sqrt(d)) V runs in float32 with TF32 off (the JAX
    package pins ``Precision.HIGHEST``)."""

    q: SparseProjection
    k: SparseProjection
    v: SparseProjection
    device: Union[str, torch.device] = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.packed = {name: getattr(self, name).to(self.device)
                       for name in ("q", "k", "v")}

    @classmethod
    def from_fixture_root(cls, root: str, device: Union[str, torch.device]
                          = "cuda") -> "SparseAttentionInt8":
        """A directory holding ``q/``, ``k/`` and ``v/`` fixture
        directories (``generate_all_fixtures``' ``transformer/80pct``)."""
        subs = {}
        for name in ("q", "k", "v"):
            p = os.path.join(root, name)
            if not os.path.isdir(p):
                raise FileNotFoundError(f"missing projection dir {p}")
            subs[name] = SparseProjection.from_fixture_dir(p)
        return cls(q=subs["q"], k=subs["k"], v=subs["v"], device=device)

    def sparsity_report(self) -> Dict[str, float]:
        return {name: proj.bsr.sparsity_pct / 100.0
                for name, proj in
                (("q", self.q), ("k", self.k), ("v", self.v))}

    def __call__(self, x) -> torch.Tensor:
        """[T, d_model] float32 (array or tensor) -> [T, d_head] float32 on
        ``device``."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        x_scale = torch.clamp_min(x.abs().max() / 127.0, 1e-12)
        xq = torch.clamp(torch.round(x / x_scale), -128, 127).to(torch.int8)
        q, k, v = (self.packed[n].project(xq, x_scale)
                   for n in ("q", "k", "v"))
        d = q.shape[-1]
        cuda_tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            logits = (q @ k.T) / torch.sqrt(torch.tensor(
                d, dtype=torch.float32, device=self.device))
            return torch.softmax(logits, dim=-1) @ v
        finally:
            torch.backends.cuda.matmul.allow_tf32 = cuda_tf32

    def forward_golden(self, x: np.ndarray) -> np.ndarray:
        """The numpy golden of ``__call__``."""
        x = np.asarray(x, np.float32)
        x_scale = max(float(np.abs(x).max()) / 127.0, 1e-12)
        xq = np.clip(np.rint(x / x_scale), -128, 127).astype(np.int8)
        q = self.q.project_golden(xq, x_scale)
        k = self.k.project_golden(xq, x_scale)
        v = self.v.project_golden(xq, x_scale)
        d = q.shape[-1]
        logits = (q @ k.T) / np.sqrt(np.float32(d))
        e = np.exp(logits - logits.max(axis=-1, keepdims=True))
        attn = e / e.sum(axis=-1, keepdims=True)
        return attn @ v
