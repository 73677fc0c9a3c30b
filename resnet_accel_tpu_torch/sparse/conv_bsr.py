"""Tap-aligned block-sparse conv weights, in numpy, and their device form.

A numpy copy of ``ConvBSR`` and ``pack_conv_bsr`` from
``resnet_accel_tpu/ops/sparse_conv.py`` (same fields, block order
(kh, kw, cb, ob), chunk padding and errors) and of ``tap_sparse_weight``
from ``tools/tune_tpu.py``, kept here so the port imports nothing of the
JAX package.  One block is ``block_c`` consecutive input channels at one
kernel tap (kh, kw) by ``block_o`` output channels; a block whose weights
are all zero is not stored.

:func:`device_pack` turns a ``ConvBSR`` into what kernel K8 reads: the
stored blocks grouped by output block as a CSR (``o_ptr``), each block
K-contiguous ``[block_o, block_c]`` (the ``mma.sync`` B fragment, and a
block row of K4's ``[nnz * block_h, block_w]`` weight on the Hopper
route), with the chunk padding dropped, and each block's column in the
dense conv's (kh, kw, c) K order (``col``), the Hopper route's walk.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from resnet_accel_tpu_torch.sparse.bsr import round_up


@dataclasses.dataclass
class ConvBSR:
    """Block-sparse conv weights packed as the JAX package packs them."""

    blocks: np.ndarray      # [nnz_pad, block_c, block_o] int8 (transposed)
    kh_of: np.ndarray       # [nnz_pad] int32
    kw_of: np.ndarray       # [nnz_pad] int32
    c_of: np.ndarray        # [nnz_pad] int32 (channel-block index)
    o_of: np.ndarray        # [nnz_pad] int32 (output-block index)
    nnz: int                # scheduled blocks (incl. padding)
    nnz_source: int         # true nonzero blocks
    total_source: int
    chunk: int
    kernel: int
    padding: int
    c_in: int
    c_out: int
    block_c: int
    block_o: int

    @property
    def sparsity(self) -> float:
        return 1.0 - self.nnz_source / self.total_source


def pack_conv_bsr(
    w4d: np.ndarray,
    padding: int,
    block_o: int = 128,
    block_c: Optional[int] = None,
    chunk: int = 8,
) -> ConvBSR:
    """Pack int8 conv weights [O, C, kh, kw] into tap-aligned BSR blocks.

    A block is zero (skipped) iff all its block_o x block_c weights at
    one (kh, kw) tap are zero.  The schedule is padded with zero blocks to
    a multiple of ``chunk`` (the TPU kernel's grid step).
    """
    w4d = np.asarray(w4d, np.int8)
    O, C, KH, KW = w4d.shape
    if block_c is None:
        block_c = min(C, 128)
    if C % block_c:
        raise ValueError(f"C={C} not a multiple of block_c={block_c}")
    block_o_eff = min(block_o, round_up(O, 8))
    Op = round_up(O, block_o_eff)
    if Op != O:
        w4d = np.concatenate(
            [w4d, np.zeros((Op - O, C, KH, KW), np.int8)], axis=0)

    n_ob, n_cb = Op // block_o_eff, C // block_c
    blocks, khs, kws, cbs, obs = [], [], [], [], []
    for kh in range(KH):
        for kw in range(KW):
            for cb in range(n_cb):
                for ob in range(n_ob):
                    blk = w4d[ob * block_o_eff:(ob + 1) * block_o_eff,
                              cb * block_c:(cb + 1) * block_c, kh, kw]
                    if not np.any(blk):
                        continue
                    blocks.append(np.ascontiguousarray(blk.T))
                    khs.append(kh)
                    kws.append(kw)
                    cbs.append(cb)
                    obs.append(ob)
    nnz_source = len(blocks)
    pad = -len(blocks) % chunk if blocks else chunk
    blocks += [np.zeros((block_c, block_o_eff), np.int8)] * pad
    for meta in (khs, kws, cbs, obs):
        meta += [0] * pad
    return ConvBSR(
        blocks=np.stack(blocks),
        kh_of=np.asarray(khs, np.int32),
        kw_of=np.asarray(kws, np.int32),
        c_of=np.asarray(cbs, np.int32),
        o_of=np.asarray(obs, np.int32),
        nnz=len(blocks),
        nnz_source=nnz_source,
        total_source=KH * KW * n_cb * n_ob,
        chunk=chunk,
        kernel=KH,
        padding=padding,
        c_in=C,
        c_out=O,
        block_c=block_c,
        block_o=block_o_eff,
    )


def tap_sparse_weight(rng: np.random.Generator, o: int, c: int, k: int,
                      sparsity: float, block_o: int = 128,
                      block_c: Optional[int] = None) -> np.ndarray:
    """Random int8 conv weights [o, c, k, k] with each tap-aligned
    ``block_o x block_c`` block zeroed with probability ``sparsity``
    (the conv sweep's weights; draws from ``rng`` in the sweep's order)."""
    block_c = block_c or min(c, 128)
    w = rng.integers(-128, 128, (o, c, k, k)).astype(np.int8)
    for kh in range(k):
        for kw in range(k):
            for cb in range(c // block_c):
                for ob in range(-(-o // block_o)):
                    if rng.random() < sparsity:
                        w[ob * block_o:(ob + 1) * block_o,
                          cb * block_c:(cb + 1) * block_c, kh, kw] = 0
    return w


@dataclasses.dataclass
class PackedConvBSR:
    """A ``ConvBSR`` on a device in the layout kernel K8 walks: the stored
    blocks of output block ``ob`` are ``blocks[o_ptr[ob]:o_ptr[ob + 1]]``
    (in the packer's (kh, kw, cb) order), block ``i`` at tap
    (``kh[i]``, ``kw[i]``) and channel block ``cb[i]``, stored
    [block_o, block_c] so a row of output channel weights is contiguous.

    ``col[i]`` is block ``i``'s block column in the dense conv's K order
    (kh, kw, c), ``(kh * kernel + kw) * (c_in / block_c) + cb``: with
    ``o_ptr`` as row pointers it makes the stored blocks a BSR weight over
    the conv's patch matrix, block ``i`` covering its K bytes
    ``[col * block_c, col * block_c + block_c)`` -- tap ``kh * kernel +
    kw``, channels from ``cb * block_c`` -- which the Hopper route walks
    (K4's walk over K2's im2col windows)."""

    blocks: torch.Tensor     # [nnz_source, block_o, block_c] int8
    o_ptr: torch.Tensor      # [n_ob + 1] int32
    kh: torch.Tensor         # [nnz_source] int32
    kw: torch.Tensor
    cb: torch.Tensor
    col: torch.Tensor        # [nnz_source] int32
    kernel: int
    padding: int
    c_in: int
    c_out: int
    block_c: int
    block_o: int
    nnz_source: int
    total_source: int

    @property
    def n_ob(self) -> int:
        return self.o_ptr.numel() - 1


def device_pack(cbsr: ConvBSR, device) -> PackedConvBSR:
    """Regroup ``cbsr``'s stored blocks by output block and upload them to
    ``device`` for :func:`~resnet_accel_tpu_torch.ops.sparse_conv2d_int8`."""
    n = cbsr.nnz_source                   # the chunk padding comes last
    n_ob = round_up(cbsr.c_out, cbsr.block_o) // cbsr.block_o
    order = np.argsort(cbsr.o_of[:n], kind="stable")
    o_ptr = np.zeros(n_ob + 1, np.int32)
    o_ptr[1:] = np.cumsum(np.bincount(cbsr.o_of[:n], minlength=n_ob))

    def put(arr, dtype):
        return torch.from_numpy(np.ascontiguousarray(arr, dtype)).to(device)

    blocks = np.asarray(cbsr.blocks[:n][order], np.int8).transpose(0, 2, 1)
    kh, kw, cb = (a[:n][order] for a in (cbsr.kh_of, cbsr.kw_of, cbsr.c_of))
    col = (kh * cbsr.kernel + kw) * (cbsr.c_in // cbsr.block_c) + cb
    return PackedConvBSR(
        blocks=put(blocks.reshape(n, cbsr.block_o, cbsr.block_c), np.int8),
        o_ptr=put(o_ptr, np.int32),
        kh=put(kh, np.int32), kw=put(kw, np.int32), cb=put(cb, np.int32),
        col=put(col, np.int32),
        kernel=cbsr.kernel, padding=cbsr.padding, c_in=cbsr.c_in,
        c_out=cbsr.c_out, block_c=cbsr.block_c, block_o=cbsr.block_o,
        nnz_source=cbsr.nnz_source, total_source=cbsr.total_source)
