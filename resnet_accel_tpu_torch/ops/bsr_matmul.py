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
epilogue), as the TPU kernel's zero filler block does.  The kernel has three
paths, chosen by shape (:func:`bsr_plan`): the Hopper main loop (TMA,
``wgmma``, split-K clusters) for blocks the tensor-core tiles take, every
128 x 128 path served; the small-block path for blocks of at most 16 x 16
(the reference's 14 x 14, 8 x 8), which walks the block rows two blocks a
stage, each in the 32-byte K window that holds it (:func:`small_stages`);
the ``mma.sync`` path for any other block shape or a K that TMA refuses.

``bsr_matmul_wt_xla`` over a :class:`GatherBSR` is the other route, the
one the LM's projections take, as the JAX package's LM does: the
counterpart of the JAX package's XLA composition of the same name.  Its
packers: :func:`pack_gather_bsr` from a host ``BSRMatrix``,
:func:`device_pack_gather` from a dense int8 weight already on a device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from resnet_accel_tpu_torch import _kernels
from resnet_accel_tpu_torch._kernels import GemmPlan, cluster_split
from resnet_accel_tpu_torch.ops.epilogue import requantize
from resnet_accel_tpu_torch.sparse.bsr import BSRMatrix, round_up


#: The largest block side of the small-block path: a block padded to 16
#: rows is the N of one ``wgmma`` (m64n16k32), and its K values fit, at any
#: offset, in the 32-byte aligned window that holds them.
SMALL_BLOCK = 16
#: K bytes of a small-block window: one ``wgmma`` k32 step.
SMALL_WINDOW = 32
#: Bytes of one small-block stage's weight image: two 16 x 32 windows.
SMALL_STAGE_BYTES = 2 * SMALL_BLOCK * SMALL_WINDOW


def small_stages(bsr: BSRMatrix):
    """The small-block path's walk of ``bsr`` (blocks of at most 16 x 16):
    each block row's stored blocks, in order, paired into stages (an odd
    row's last stage pairs its block with a zero one).

    A block at block column ``c`` covers A's K bytes [bw * c, bw * c + bw);
    TMA loads A only at 16-byte aligned K, so the kernel loads the 32-byte
    window from ``x0 = bw * c - d``, ``d = (bw * c) % 16``, and the block's
    image is that window of W: 16 rows x 32 K bytes, the block at columns
    [d, d + bw), zero elsewhere (the window's other bytes of A meet zeros,
    so the int32 sum stays exact).

    Returns ``(stages, stage_ptr, stage_col)``: ``stages`` [n_stages, 1024]
    int8, each stage's two windows row-major (rows 0-15 the first block's,
    16-31 the second's); ``stage_ptr`` [nbr + 1] int32, the stages of block
    row ``br`` being ``stage_ptr[br]:stage_ptr[br + 1]``; ``stage_col``
    [n_stages, 2] int32, the block columns of the two blocks (-1 for the
    zero one)."""
    bh, bw = bsr.block_h, bsr.block_w
    if bh > SMALL_BLOCK or bw > SMALL_BLOCK:
        raise ValueError(f"small_stages takes blocks of at most "
                         f"{SMALL_BLOCK} x {SMALL_BLOCK}, not {bh} x {bw}")
    row_ptr = np.asarray(bsr.row_ptr, np.int64)
    counts = np.diff(row_ptr)
    stage_ptr = np.concatenate([[0], np.cumsum((counts + 1) // 2)])
    n_stages = int(stage_ptr[-1])
    row_of = np.repeat(np.arange(counts.size), counts)
    slot = 2 * stage_ptr[row_of] + np.arange(row_ptr[-1]) - row_ptr[row_of]
    col_idx = np.asarray(bsr.col_idx, np.int64)
    shift = (bw * col_idx) % 16                  # d of each stored block
    img = np.zeros((2 * n_stages, SMALL_BLOCK, SMALL_WINDOW), np.int8)
    data = np.asarray(bsr.data, np.int8).reshape(-1, bh, bw)
    for d in np.unique(shift):
        at = shift == d
        img[slot[at], :bh, d:d + bw] = data[at]
    col = np.full(2 * n_stages, -1, np.int32)
    col[slot] = col_idx
    return (img.reshape(n_stages, SMALL_STAGE_BYTES),
            stage_ptr.astype(np.int32), col.reshape(n_stages, 2))


@dataclasses.dataclass
class PackedBSR:
    """A ``BSRMatrix`` of int8 blocks on a device, in the CSR layout the
    kernel walks: the blocks of block row ``br`` are
    ``blocks[row_ptr[br]:row_ptr[br + 1]]``, each [block_h, block_w] in
    the W[N, K] orientation, at block column ``col_idx[i]``.  Blocks of at
    most 16 x 16 also carry the small-block path's stages
    (:func:`small_stages`); other blocks carry None there."""

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
    max_row_blocks: int      # the fullest block row's stored blocks
    stages: Optional[torch.Tensor] = None     # [n_stages, 1024] int8
    stage_ptr: Optional[torch.Tensor] = None  # [n_padded / block_h + 1]
    stage_col: Optional[torch.Tensor] = None  # [n_stages, 2] int32
    max_row_stages: int = 0  # the fullest block row's stages


def pack_bsr(bsr: BSRMatrix, device) -> PackedBSR:
    """Upload an int8 ``BSRMatrix`` to ``device`` for :func:`bsr_matmul_wt`."""
    if bsr.data.dtype != np.int8:
        raise ValueError("pack_bsr needs int8 blocks")

    def put(arr, dtype):
        return torch.from_numpy(np.ascontiguousarray(arr, dtype)).to(device)

    counts = np.diff(np.asarray(bsr.row_ptr))
    small = {}
    if bsr.block_h <= SMALL_BLOCK and bsr.block_w <= SMALL_BLOCK:
        stages, stage_ptr, stage_col = small_stages(bsr)
        small = dict(stages=put(stages, np.int8),
                     stage_ptr=put(stage_ptr, np.int32),
                     stage_col=put(stage_col, np.int32),
                     max_row_stages=int(np.diff(stage_ptr).max(initial=0)))
    return PackedBSR(
        blocks=put(bsr.data, np.int8).reshape(-1, bsr.block_h, bsr.block_w),
        row_ptr=put(bsr.row_ptr, np.int32),
        col_idx=put(bsr.col_idx, np.int32),
        block_h=bsr.block_h, block_w=bsr.block_w,
        n_out=bsr.shape[0], k_dim=bsr.shape[1],
        n_padded=bsr.padded_shape[0], k_padded=bsr.padded_shape[1],
        nnz_source=bsr.nnz_blocks, total_source=bsr.total_blocks,
        max_row_blocks=int(counts.max()) if counts.size else 0, **small)


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
    """Plain PyTorch version of K4, its test reference: gather the K slab
    of A each stored block needs, contract it with the block, add each
    product into its block row.  In float64, which is exact (see
    ``matmul_int8_plain``), for any block size."""
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


def bsr_plan(a: torch.Tensor, packed: PackedBSR,
             sms: int = _kernels.H100_SMS) -> GemmPlan:
    """K4's path for ``a`` against ``packed``, by shape.

    Both tensor-core paths load A through TMA, which needs K % 16 == 0 and
    16-byte aligned bases.  Where it takes them:

    - ``wgmma_tma``, the Hopper main loop, where its tiles take the blocks
      (``block_w % 32 == 0``, ``block_h % 8 == 0``, ``block_h <= 256``:
      the limits of ``wgmma``'s N).  Its N tile is the smallest of 64, 128
      and 256 that holds a block row's outputs (64 where the row ends in
      padding, as in the stage-1 convs: n_out 64 inside block_h 128).
    - ``wgmma_small`` for the other blocks of at most 16 x 16 (the
      reference's 14 x 14, 8 x 8): one block row of a 128-row M tile a
      CTA, each block one 32-byte K window, two a stage
      (:func:`small_stages`), N tile 16.

    Each block row's walk (stored blocks, or stages) is split across a
    cluster of two while the grid of M tiles x block rows leaves half the
    card's ``sms`` SMs idle (:func:`cluster_split`).  Every other shape
    (16 x 24, 16 x 48 ..., or K % 16 != 0): ``mma_sync``, whose
    ``mma.sync`` tiles take any block."""
    bh, bw = packed.block_h, packed.block_w
    M, K = a.shape
    ctas = -(-M // 128) * (packed.n_padded // bh)
    tma = K % 16 == 0 and a.data_ptr() % 16 == 0
    if (tma and bw % 32 == 0 and bh % 8 == 0 and bh <= 256
            and packed.blocks.data_ptr() % 16 == 0):
        need = min(bh, packed.n_out)
        bn = 64 if need <= 64 else 128 if need <= 128 else 256
        stages = bw // (128 if bw % 128 == 0 else 64 if bw % 64 == 0
                        else 32)
        return GemmPlan("wgmma_tma", bn, cluster_split(
            ctas, packed.max_row_blocks * stages, sms))
    if (tma and packed.stages is not None
            and packed.stages.data_ptr() % 16 == 0):
        return GemmPlan("wgmma_small", SMALL_BLOCK, cluster_split(
            ctas, packed.max_row_stages, sms))
    return GemmPlan("mma_sync", 0, 1)


#: The C launcher's path codes, by variant.
_PATHS = {"mma_sync": 0, "wgmma_tma": 1, "wgmma_small": 2}


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
    when ``factors`` is given, else int32.  Any block shape; the kernel's
    path is :func:`bsr_plan`'s."""
    _check_k(a, packed)
    if a.device.type == "cpu":
        return bsr_matmul_wt_plain(a, packed, bias=bias, factors=factors,
                                   relu=relu)
    if a.device.type != "cuda":
        raise ValueError(f"bsr_matmul_wt: unsupported device {a.device}")
    bh, bw = packed.block_h, packed.block_w
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
    plan = bsr_plan(a, packed, _kernels.sm_count(dev))
    # The mma.sync path: 16-byte loads of A need aligned rows, other A take a
    # byte gather.
    vec_a = K % 16 == 0 and a.data_ptr() % 16 == 0
    walk = (packed.blocks, packed.row_ptr, packed.col_idx, packed.nnz_source)
    if plan.variant == "wgmma_small":
        # the same arguments carry the stages: images, row pointers, columns
        n_stages = packed.stages.shape[0]
        _kernels.check(packed.stages, "stages", torch.int8,
                       (n_stages, SMALL_STAGE_BYTES), dev)
        _kernels.check(packed.stage_ptr, "stage_ptr", torch.int32,
                       (nbr + 1,), dev)
        _kernels.check(packed.stage_col, "stage_col", torch.int32,
                       (n_stages, 2), dev)
        walk = (packed.stages, packed.stage_ptr, packed.stage_col, n_stages)
    blocks, row_ptr, col_idx, nnz = walk
    _kernels.launch(
        "bsr_matmul", dev, a.data_ptr(), blocks.data_ptr(),
        row_ptr.data_ptr(), col_idx.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if factors is None else factors.data_ptr(), out.data_ptr(),
        M, K, N, nbr, bh, bw, int(relu), int(factors is not None),
        int(vec_a), _PATHS[plan.variant], plan.bn, plan.split, nnz,
        variant=plan.variant)
    return out


# -------------------------------------------------------------------------
# Gather-compact route (any block shape; the LM's 8 x 8 projections)
# -------------------------------------------------------------------------

@dataclasses.dataclass
class GatherBSR:
    """BSR repacked as rectangular arrays on a device: each block row's
    stored blocks padded to ``lmax`` (the fullest row's count) with zero
    blocks at gather index 0, so the ragged CSR walk becomes one batched
    product over the padded blocks."""

    blocks: torch.Tensor       # [nbr, lmax, bh, bw] int8
    gather_idx: torch.Tensor   # [nbr, lmax] int64, K-block indices
    weight: torch.Tensor       # [nbr, lmax * bw, bh] float64, the product's B
    lmax: int
    block_h: int
    block_w: int
    n_out: int
    k_dim: int
    n_padded: int
    k_padded: int


def pack_gather_bsr(bsr: BSRMatrix, device) -> GatherBSR:
    """Counterpart of the JAX ``pack_gather_bsr``, on ``device``."""
    if bsr.data.dtype != np.int8:
        raise ValueError("gather BSR requires int8 blocks")
    bh, bw = bsr.block_h, bsr.block_w
    nbr = bsr.num_block_rows
    rp = np.asarray(bsr.row_ptr)
    counts = np.diff(rp)
    lmax = max(int(counts.max()) if counts.size else 0, 1)
    blocks = np.zeros((nbr, lmax, bh, bw), dtype=np.int8)
    gidx = np.zeros((nbr, lmax), dtype=np.int64)
    for br in range(nbr):
        lo, hi = int(rp[br]), int(rp[br + 1])
        blocks[br, :hi - lo] = bsr.data[lo:hi]
        gidx[br, :hi - lo] = bsr.col_idx[lo:hi]
    weight = blocks.astype(np.float64).transpose(0, 1, 3, 2).reshape(
        nbr, lmax * bw, bh)
    return GatherBSR(
        blocks=torch.from_numpy(blocks).to(device),
        gather_idx=torch.from_numpy(gidx).to(device),
        weight=torch.from_numpy(np.ascontiguousarray(weight)).to(device),
        lmax=lmax, block_h=bh, block_w=bw,
        n_out=bsr.shape[0], k_dim=bsr.shape[1],
        n_padded=bsr.padded_shape[0], k_padded=bsr.padded_shape[1])


def device_pack_gather(w2d: torch.Tensor, block_h: int,
                       block_w: Optional[int] = None,
                       lmax: Optional[int] = None) -> GatherBSR:
    """Pack a dense int8 weight W[N, K] into a :class:`GatherBSR` on its
    own device, in torch ops: the counterpart of the JAX package's
    ``sparse/device_pack.py::device_pack_gather`` (an XLA composition
    there too, no Pallas kernel), for weights that arrive on the card
    dense.

    Every block row keeps ``lmax`` slots (default: the dense block count
    of a row): its nonzero blocks in ascending column order, then zero
    filler blocks at gather index 0.  Raises ValueError on a weight that is
    not int8 and on a block row with more than ``lmax`` nonzero blocks
    (which the fixed slots would cut off)."""
    if w2d.dtype != torch.int8:
        raise ValueError("device pack expects int8 weights")
    if block_w is None:
        block_w = block_h
    n, k = w2d.shape
    np_, kp = round_up(n, block_h), round_up(k, block_w)
    nbr, nbc = np_ // block_h, kp // block_w
    lmax = nbc if lmax is None else min(lmax, nbc)
    tiles = F.pad(w2d, (0, kp - k, 0, np_ - n)).reshape(
        nbr, block_h, nbc, block_w).permute(0, 2, 1, 3)
    nz = (tiles != 0).any(dim=3).any(dim=2)                 # [nbr, nbc]
    counts = nz.sum(dim=1)
    most = int(counts.max()) if nbr else 0
    if most > lmax:
        raise ValueError(f"lmax={lmax} too small: a block-row has {most} "
                         f"nonzero blocks")
    # the nonzero columns first, each row's in ascending order (stable)
    order = torch.sort((~nz).to(torch.uint8), dim=1, stable=True).indices
    valid = (torch.arange(lmax, device=w2d.device)[None, :]
             < counts[:, None])                              # [nbr, lmax]
    gidx = torch.where(valid, order[:, :lmax], 0)
    rows = torch.arange(nbr, device=w2d.device)[:, None]
    blocks = torch.where(valid[:, :, None, None], tiles[rows, gidx],
                         torch.zeros((), dtype=torch.int8,
                                     device=w2d.device))
    weight = blocks.to(torch.float64).transpose(2, 3).reshape(
        nbr, lmax * block_w, block_h)
    return GatherBSR(
        blocks=blocks.contiguous(), gather_idx=gidx.contiguous(),
        weight=weight.contiguous(), lmax=lmax, block_h=block_h,
        block_w=block_w, n_out=n, k_dim=k, n_padded=np_, k_padded=kp)


def bsr_matmul_wt_xla(a: torch.Tensor, g: GatherBSR) -> torch.Tensor:
    """C[M, n_out] = A[M, K] @ W^T for int8 ``a``, int32, bit-exact.

    The counterpart of the JAX ``bsr_matmul_wt_xla``, a composition that
    the JAX package, too, leaves to the compiler outside any kernel: gather
    the K slab of A that each padded block needs, one batched product over
    the block rows, slice to ``n_out``.  Work scales with the padded stored
    blocks, so the zero-block skip holds here as well.  This is the route
    of the LM's 8 x 8 blocks, and it is not K4's plain version: that one,
    :func:`bsr_matmul_wt_plain`, stays K4's reference.

    The product runs in float64, never TF32: every term is an integer of
    at most 2^14 and a sum has at most K terms, far below 2^53, so every
    partial sum is exact in any order.  (Float32 would be exact only while
    K * 2^14 <= 2^24; the LM's w2 has K = 1024, right at that edge.)"""
    if a.ndim != 2:
        raise ValueError(f"A must be 2-D, got shape {tuple(a.shape)}")
    M, K = a.shape
    if K not in (g.k_dim, g.k_padded):
        raise ValueError(f"A has K={K}, BSR expects {g.k_dim} "
                         f"(padded {g.k_padded})")
    nbr = g.gather_idx.shape[0]
    a = F.pad(a, (0, g.k_padded - K))
    slabs = a.reshape(M, g.k_padded // g.block_w, g.block_w).index_select(
        1, g.gather_idx.reshape(-1))                  # [M, nbr * lmax, bw]
    slabs = slabs.to(torch.float64).reshape(M, nbr, g.lmax * g.block_w)
    out = torch.bmm(slabs.transpose(0, 1), g.weight)   # [nbr, M, bh]
    return out.transpose(0, 1).reshape(M, -1)[:, :g.n_out].to(torch.int32)
