"""K4's conv route: the zero-skip int8 conv of a layer held in small BSR
blocks, one launch a conv, and its plain version.

A layer whose weight ``attach_bsr`` stored in blocks of at most 16 x 16
(the reference's 14 x 14, 8 x 8; blocks over the (c, kh, kw) flattening,
not aligned to a conv tap, so K8 cannot take them) ran as three stages:
:func:`~resnet_accel_tpu_torch.ops.conv.im2col_nchw`, K4's small-block
path over the patch matrix, and the eager residual join.  Both versions
here compute the same function:

    q = K4(im2col(x), packed, bias, factors, relu)        int8 [N*Ho*Wo, O]
    with a residual r and (s_main, s_res, s_out):
    q = max(clip(rint((q*s_main + r*s_res) / s_out), -128, 127), 0)

:func:`bsr_conv2d_int8_plain` is that composition, the test reference and
the CPU path.  :func:`bsr_conv2d_int8` launches ``csrc/bsr_conv.cu`` for
CUDA tensors: each CTA stages its tile's input rows in shared memory once,
walks a run of block rows column by column
(:func:`~resnet_accel_tpu_torch.ops.bsr_matmul.conv_walk`), gathers each
column's 32-byte K window from the staged rows into the tensor cores'
register operand through the gather table (:func:`conv_gather_table`),
multiplies it in one MMA by the column's image for every row of the run
(K4's small-block images,
:func:`~resnet_accel_tpu_torch.ops.bsr_matmul.small_stages`, packed in the
walk's order, or a zero image where the row does not store the column)
and joins the residual in its epilogue, so neither the
patch matrix nor the pre-join tensor reaches device memory.  Its tile is
:func:`bsr_conv_plan`'s, chosen by shape.  K4's GEMM callers (the MNIST
fc1, ``bench --artifact``, the data-parallel GEMM) have no conv geometry
and keep ``bsr_matmul_wt``.

Tensors are NCHW at this interface, as in the JAX package; the kernel
reads ``x`` and ``residual`` in channels-last memory order and returns a
channels-last output, as ``conv2d_int8`` does.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from resnet_accel_tpu_torch import _kernels
from resnet_accel_tpu_torch.ops.bsr_matmul import (CONV_WALK_ROWS,
                                                   SMALL_BLOCK,
                                                   SMALL_WINDOW, PackedBSR,
                                                   bsr_matmul_wt_plain)
from resnet_accel_tpu_torch.ops.conv import (Padding, _out_hw, _pads,
                                             im2col_nchw)
from resnet_accel_tpu_torch.ops.epilogue import add_residual

#: Shared memory a CTA may use on the H100 (227 KB).
MAX_SMEM = 232448
CHANNELS = SMALL_BLOCK * CONV_WALK_ROWS
RING = 4
IMAGE_BYTES = SMALL_BLOCK * SMALL_WINDOW


def head_smem(rows: int) -> int:
    """The kernel's shared memory before the staged tile for runs of
    ``rows`` block rows (``head`` in ``csrc/bsr_conv.cu``): alignment
    slack, a ring of RING columns' images (one for each row, 512 bytes an
    image), the ring's mbarriers, the run's biases and factors."""
    return 1024 + RING * rows * IMAGE_BYTES + 16 * RING + 8 * CHANNELS


#: Bytes a row of the staged residual (the run's channels, from a 4-byte
#: boundary).
RES_PITCH = CHANNELS + 8
#: At 64 pixels a CTA's second warpgroup hands its sums over the staged
#: tile's space, which holds at least this much (``kPart``).
PART_SMEM = CONV_WALK_ROWS * 64 * SMALL_BLOCK * 4
#: The most a CTA of 128 pixels may take and still share an SM with a
#: second one (228 KB an SM, 1 KB of each CTA reserved).
TWO_CTA_SMEM = 228 * 1024 // 2 - 1024


@dataclasses.dataclass(frozen=True)
class ConvStaging:
    """Where a conv's input lies in the kernel's staged tile.

    The tile holds rows of the zero-padded input of every image back to
    back, ``Hs`` rows an image, ``Ws`` pixels a row, ``P`` bytes a pixel
    (its C channels, then ``chunk`` bytes of slack that put consecutive
    pixels in different shared-memory banks).  Staged pixel (hs, ws) is
    x's (hs * ss - pad_h, ws * ss - pad_w); the conv walks the tile at
    stride ``se``.  A 1 x 1 conv of stride s stages only x's every s-th row
    and column (ss = s) and walks them at stride 1; any other conv stages
    the padded input (ss = 1) at its own stride."""

    Ho: int
    Wo: int
    Hs: int
    Ws: int
    ss: int
    se: int
    pad_h: int
    pad_w: int
    chunk: int
    P: int


def conv_staging(C: int, H: int, W: int, kernel: int, stride: int,
                 padding: Padding) -> ConvStaging:
    """The staged tile's geometry for a conv of ``kernel`` x ``kernel`` at
    ``stride`` over [., C, H, W]; ``chunk`` 8 where C % 8 == 0, else 4."""
    (t, b), (l, r) = _pads(padding)
    Ho, Wo = _out_hw(H, W, kernel, stride, padding)
    if kernel == 1:
        Hs, Ws, ss, se = Ho, Wo, stride, 1
    else:
        Hs, Ws, ss, se = H + t + b, W + l + r, 1, stride
    chunk = 8 if C % 8 == 0 else 4
    return ConvStaging(Ho, Wo, Hs, Ws, ss, se, t, l, chunk, C + chunk)


def conv_gather_table(C: int, kernel: int, Ws: int, P: int,
                      length: int) -> np.ndarray:
    """[length] int32: for each K column k = c * kernel^2 + kh * kernel +
    kw (``im2col_nchw``'s order) the byte of its tap in the staged tile,
    relative to the pixel's top-left tap: kh * Ws * P + kw * P + c.
    Columns past K (C * kernel^2) map to 0, the top-left tap itself: an
    in-bounds byte, met by the zero weights of the padding."""
    k = np.arange(length, dtype=np.int64)
    kk = kernel * kernel
    kh, kw = (k % kk) // kernel, k % kernel
    off = kh * Ws * P + kw * P + k // kk
    off[k >= C * kk] = 0
    return off.astype(np.int32)


def table_length(k_padded: int) -> int:
    """Entries of the gather table for a weight of ``k_padded`` columns:
    every 32-byte window a stored block's (16-byte aligned) start opens,
    read as 16-byte vectors."""
    return -(-k_padded // 16) * 16 + SMALL_WINDOW


@functools.lru_cache(maxsize=None)
def _device_table(C: int, kernel: int, Ws: int, P: int, length: int,
                  device: torch.device) -> torch.Tensor:
    """:func:`conv_gather_table` on ``device``, made once a geometry and
    input width (every layer of that geometry shares it)."""
    return torch.from_numpy(conv_gather_table(C, kernel, Ws, P,
                                              length)).to(device)


@dataclasses.dataclass(frozen=True)
class ConvRoutePlan:
    """The conv route's tile: ``mt`` output pixels a CTA, ``stage_rows``
    staged rows of its largest tile, and the CTA's shared memory, ``smem``
    bytes.  Each M tile takes one CTA a run of block rows
    (:func:`~resnet_accel_tpu_torch.ops.bsr_matmul.conv_walk`)."""

    mt: int
    stage_rows: int
    smem: int


def _stage_rows(N: int, st: ConvStaging, kernel: int, mt: int) -> int:
    """The most staged rows any M tile of ``mt`` pixels covers: from its
    first pixel's top row to its last pixel's bottom row, the images' rows
    counted back to back (``staged_row`` in the kernel)."""
    M = N * st.Ho * st.Wo
    first = np.arange(0, M, mt, dtype=np.int64)
    last = np.minimum(first + mt, M) - 1

    def row(m):
        n = m // (st.Ho * st.Wo)
        return n * st.Hs + (m - n * st.Ho * st.Wo) // st.Wo * st.se
    return int((row(last) + kernel - row(first)).max())


@functools.lru_cache(maxsize=None)
def bsr_conv_plan(N: int, C: int, H: int, W: int, kernel: int, stride: int,
                  padding: Padding, residual: bool,
                  rows: int = CONV_WALK_ROWS) -> ConvRoutePlan:
    """The conv route's tile for ``N`` images [C, H, W] and runs of
    ``rows`` block rows, by shape.

    ``mt`` is 128 where such a tile's staging (and its staged residual,
    where the conv joins one) lets two CTAs share an SM: every stage of
    ResNet-18 at 224 x 224 but the last, whose 7 x 7 images put three in a
    tile of 128; there each of the CTA's two warpgroups takes 64 of the
    rows.  Else 64, each warpgroup taking every other column.  Raises
    ValueError where even 64 pixels' rows do not fit."""
    st = conv_staging(C, H, W, kernel, stride, padding)
    M = N * st.Ho * st.Wo
    for mt in (128, 64):
        staged = _stage_rows(N, st, kernel, mt) if M else kernel
        smem = (head_smem(rows)
                + max(-(-staged * st.Ws * st.P // 16) * 16,
                      PART_SMEM if mt == 64 else 0)
                + (mt * RES_PITCH if residual else 0))
        if smem <= (TWO_CTA_SMEM if mt == 128 else MAX_SMEM):
            break
    else:
        raise ValueError(f"bsr_conv2d_int8: {staged} staged rows of {st.Ws} "
                         f"pixels x {st.P} bytes exceed shared memory")
    return ConvRoutePlan(mt, staged, smem)


def bsr_conv2d_int8_plain(
    x: torch.Tensor,
    packed: PackedBSR,
    bias: torch.Tensor,
    factors: torch.Tensor,
    *,
    kernel: int,
    stride: int,
    padding: Padding,
    relu: bool,
    residual: Optional[torch.Tensor] = None,
    res_scales: Optional[Tuple[float, float, float]] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the conv route, its test reference: the
    three stages it replaces, ``im2col_nchw``, K4's plain version and
    ``add_residual`` with the golden divide.  Returns [N, O, Ho, Wo] int8,
    channels-last."""
    N, _, H, W = x.shape
    Ho, Wo = _out_hw(H, W, kernel, stride, padding)
    a = im2col_nchw(x, kernel, stride, padding).reshape(N * Ho * Wo, -1)
    q = bsr_matmul_wt_plain(a, packed, bias=bias, factors=factors,
                            relu=relu)
    # [N*Ho*Wo, O] is NHWC: as NCHW it is channels-last already
    q = q.view(N, Ho, Wo, -1).permute(0, 3, 1, 2)
    if residual is not None:
        q = add_residual(q, residual, *res_scales, relu=True)
    return q.contiguous(memory_format=torch.channels_last)


def bsr_conv2d_int8(
    x: torch.Tensor,
    packed: PackedBSR,
    bias: torch.Tensor,
    factors: torch.Tensor,
    *,
    kernel: int,
    stride: int,
    padding: Padding,
    relu: bool,
    residual: Optional[torch.Tensor] = None,
    res_scales: Optional[Tuple[float, float, float]] = None,
) -> torch.Tensor:
    """The zero-skip int8 conv of ``x`` [N, C, H, W] (channels-last on
    CUDA) against ``packed``, the BSR form of the [O, C * kernel^2] weight
    in blocks of at most 16 x 16, with int32 ``bias`` [O], float32
    ``factors`` [O] and ReLU if ``relu``; with ``residual`` [N, O, Ho, Wo]
    int8 (channels-last) and ``res_scales`` = (s_main, s_res, s_out) the
    output is the basic block's join instead.  Returns [N, O, Ho, Wo] int8,
    channels-last.  One kernel launch on CUDA (variant ``wgmma_gather``),
    the plain version on the CPU."""
    if (residual is None) != (res_scales is None):
        raise ValueError("residual and res_scales go together")
    kw = dict(kernel=kernel, stride=stride, padding=padding, relu=relu,
              residual=residual, res_scales=res_scales)
    if x.device.type == "cpu":
        return bsr_conv2d_int8_plain(x, packed, bias, factors, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"bsr_conv2d_int8: unsupported device {x.device}")
    if packed.walk_images is None:
        raise ValueError(f"bsr_conv2d_int8 takes blocks of at most 16 x 16, "
                         f"not {packed.block_h} x {packed.block_w}")
    N, C, H, W = x.shape
    O, bh, bw = packed.n_out, packed.block_h, packed.block_w
    if C * kernel * kernel != packed.k_dim:
        raise ValueError(f"x has C={C}: the weight's K {packed.k_dim} is "
                         f"not C * {kernel}^2")
    if C % 4:
        raise ValueError(f"bsr_conv2d_int8 needs C divisible by 4, got {C}")
    st = conv_staging(C, H, W, kernel, stride, padding)
    nbr = packed.n_padded // bh
    dev = x.device
    cl = torch.channels_last
    _kernels.check(x, "x", torch.int8, (N, C, H, W), dev, cl)
    if x.data_ptr() % st.chunk:
        raise ValueError(f"x: base not {st.chunk}-byte aligned")
    _kernels.check(bias, "bias", torch.int32, (O,), dev)
    _kernels.check(factors, "factors", torch.float32, (O,), dev)
    _kernels.check(packed.row_ptr, "row_ptr", torch.int32, (nbr + 1,), dev)
    runs = -(-nbr // packed.walk_rows)
    _kernels.check(packed.walk_ptr, "walk_ptr", torch.int32, (runs + 1,),
                   dev)
    _kernels.check(packed.walk_col, "walk_col", torch.int32,
                   tuple(packed.walk_col.shape), dev)
    _kernels.check(packed.walk_images, "walk_images", torch.int8,
                   (packed.nnz_source + 1, IMAGE_BYTES), dev)
    s_main = s_res = s_out = 0.0
    if residual is not None:
        _kernels.check(residual, "residual", torch.int8,
                       (N, O, st.Ho, st.Wo), dev, cl)
        s_main, s_res, s_out = res_scales
    out = torch.empty((N, O, st.Ho, st.Wo), dtype=torch.int8, device=dev,
                      memory_format=cl)
    if out.numel() == 0:
        return out
    plan = bsr_conv_plan(N, C, H, W, kernel, stride, _pads(padding),
                         residual is not None, packed.walk_rows)
    tab = _device_table(C, kernel, st.Ws, st.P,
                        table_length(packed.k_padded), dev)
    # two channels a 2-byte store: every pair's offset even, as it is where
    # O and the block height are; the residual staged by 4-byte copies where
    # its rows are 4-byte aligned
    pairs = O % 2 == 0 and bh % 2 == 0
    res4 = residual is not None and O % 4 == 0 and residual.data_ptr() % 4 == 0
    _kernels.launch(
        "bsr_conv", dev, x.data_ptr(), packed.walk_images.data_ptr(),
        packed.row_ptr.data_ptr(), packed.walk_ptr.data_ptr(),
        packed.walk_col.data_ptr(), tab.data_ptr(), bias.data_ptr(),
        factors.data_ptr(),
        None if residual is None else residual.data_ptr(), out.data_ptr(),
        N, H, W, C, O, st.Ho, st.Wo, kernel, st.pad_h, st.pad_w, st.ss,
        st.se, st.Hs, st.Ws, st.P, st.chunk, bh, bw, nbr,
        plan.mt, packed.walk_rows, runs, plan.stage_rows,
        int(relu), int(pairs), int(res4), s_main, s_res, s_out,
        variant="wgmma_gather")
    return out
