"""PyTorch port: K4's small-block path (``wgmma_small``: blocks of at most
16 x 16, the reference's 14 x 14 and 8 x 8), modelled on the CPU.

The kernel runs only on a card (tests/test_torch_kernels.py holds it
against its plain version there).  Here its schedule is walked in plain
Python from exactly what the kernel reads: the stage images, stage
pointers and stage columns of ``small_stages``, and per stored block one A
box of 32 bytes by 128 rows at the 16-byte boundary at or below the
block's K offset (TMA refuses other inner coordinates), zero past K and M
as TMA fills it; the zero block of an odd row takes no box, so its part
of the stage holds whatever the ring held before (modelled as noise).
The walk must equal ``bsr_matmul_wt_plain`` and the JAX ``bsr_matmul_wt``
(its Pallas kernel in interpret mode) bit for bit, at every cluster
split.  Also modelled: the shared-memory byte of every (row, K) operand
that the ``wgmma`` descriptors name against where TMA's 32-byte swizzle
puts it, and the split-K shares.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from resnet_accel_tpu.ops.bsr_matmul import bsr_matmul_wt as j_bsr_matmul_wt
from resnet_accel_tpu.ops.bsr_matmul import pack_kernel_bsr
from resnet_accel_tpu.sparse import bsr as jbsr
from resnet_accel_tpu_torch import _kernels, ops
from resnet_accel_tpu_torch.ops.bsr_matmul import (SMALL_BLOCK,
                                                   SMALL_WINDOW,
                                                   small_stages)
from resnet_accel_tpu_torch.sparse import build_bsr_int8_direct

torch.set_num_threads(2)

BM = 128        # A rows a CTA (sm90::kBM)
WIN = SMALL_WINDOW


def _box(A, m0, x):
    """TMA's box of A [M, K] at (x, m0): 128 rows x 32 bytes, zero past
    K and M."""
    assert x % 16 == 0, "TMA takes 16-byte aligned inner coordinates only"
    out = np.zeros((BM, WIN), np.int64)
    part = A[m0:m0 + BM, x:x + WIN]
    out[:part.shape[0], :part.shape[1]] = part
    return out


def _walk(A, packed, split, rng):
    """The kernel's int32 sums [M, n_out], walked stage by stage: every
    (M tile, block row, rank) CTA sums its share of the row's stages."""
    M, K = A.shape
    bh, bw = packed.block_h, packed.block_w
    nbr = packed.n_padded // bh
    images = packed.stages.numpy().reshape(-1, 2, SMALL_BLOCK, WIN)
    sptr, scol = packed.stage_ptr.numpy(), packed.stage_col.numpy()
    acc = np.zeros((-(-M // BM) * BM, nbr, SMALL_BLOCK), np.int64)
    for m0 in range(0, M, BM):
        for br in range(nbr):
            n = int(sptr[br + 1] - sptr[br])
            for rank in range(split):
                for s in _kernels.split_share(n, split, rank):
                    st = sptr[br] + s
                    for b, c in enumerate(scol[st]):
                        a = (_box(A, m0, bw * c - bw * c % 16) if c >= 0
                             else rng.integers(-128, 128, (BM, WIN)))
                        acc[m0:m0 + BM, br] += a @ images[st, b].astype(
                            np.int64).T
    # the live columns of each block row, up to n_out
    return acc[:M, :, :bh].reshape(M, -1)[:, :packed.n_out]


def _epilogue(acc, bias, f, relu):
    """The kernel's epilogue of int64 sums, as the plain version's."""
    acc = torch.from_numpy(acc.astype(np.int32))
    if f is not None:
        return ops.requantize(acc, f, relu=relu, bias=bias)
    if bias is not None:
        acc = acc + bias
    return acc.clamp_min(0) if relu else acc


def _weight(rng, N, K, bh, bw, sparsity, counts=None):
    """int8 W [N, K] with bh x bw tiles zeroed with probability
    ``sparsity``; ``counts`` instead stores exactly counts[br] blocks in
    block row br, at random block columns."""
    W = rng.integers(-128, 128, (N, K)).astype(np.int8)
    nbr, nbc = -(-N // bh), -(-K // bw)
    if counts is None:
        keep = rng.random((nbr, nbc)) >= sparsity
    else:
        keep = np.zeros((nbr, nbc), bool)
        for br, n in enumerate(counts):
            keep[br, rng.choice(nbc, n, replace=False)] = True
    W *= np.repeat(np.repeat(keep, bh, 0), bw, 1)[:N, :K]
    return W


CASES = {
    # name: (M, K, N, block, sparsity, block counts of the rows)
    "14x14 dense": (150, 208, 131, 14, 0.0, None),
    "14x14 0.7": (300, 576, 64, 14, 0.7, None),
    "14x14 empty": (77, 208, 131, 14, 1.0, None),
    # odd, zero and one stored block; rows ragged against N
    "14x14 odd zero one": (129, 208, 70, 14, None, (3, 0, 1, 2, 15)),
    # K 9216: the last block column's box reaches 12 bytes past K
    "14x14 mnist fc1": (128, 9216, 28, 14, 0.9, None),
    "8x8": (130, 208, 37, 8, 0.5, None),
    "8x8 odd zero one": (64, 96, 40, 8, None, (1, 0, 5, 12, 2)),
}


def _case(name):
    M, K, N, blk, sparsity, counts = CASES[name]
    rng = np.random.default_rng(len(name) + M)
    W = _weight(rng, N, K, blk, blk, sparsity, counts)
    A = rng.integers(-128, 128, (M, K)).astype(np.int8)
    bias = rng.integers(-3000, 3000, N).astype(np.int32)
    f = (rng.uniform(0.5, 1.5, N) * 0.011 / np.sqrt(K)).astype(np.float32)
    return A, W, blk, bias, f


@pytest.mark.parametrize("requant", [False, True])
@pytest.mark.parametrize("name", list(CASES))
def test_walk_equals_plain_and_jax(name, requant):
    A, W, blk, bias, f = _case(name)
    bsr = build_bsr_int8_direct(W, blk)
    packed = ops.pack_bsr(bsr, "cpu")
    a = torch.from_numpy(A)
    plan = ops.bsr_plan(a, packed)
    assert (plan.variant, plan.bn) == ("wgmma_small", SMALL_BLOCK)
    kw = dict(bias=torch.from_numpy(bias),
              factors=torch.from_numpy(f) if requant else None,
              relu=requant)
    want = ops.bsr_matmul_wt_plain(a, packed, **kw)
    assert torch.equal(ops.bsr_matmul_wt(a, packed, **kw), want)
    rng = np.random.default_rng(0)
    for split in sorted({1, 2, 3, plan.split}):
        got = _epilogue(_walk(A.astype(np.int64), packed, split, rng),
                        kw["bias"], kw["factors"], requant)
        assert got.dtype == want.dtype and torch.equal(got, want), split
    jax_out = j_bsr_matmul_wt(
        jnp.asarray(A), pack_kernel_bsr(jbsr.build_bsr_int8_direct(W, blk)),
        bias=jnp.asarray(bias), factors=f if requant else None,
        relu=requant)
    np.testing.assert_array_equal(want.numpy(), np.asarray(jax_out))


@pytest.mark.parametrize("name", ["14x14 odd zero one", "8x8 odd zero one",
                                  "14x14 empty", "14x14 0.7"])
def test_stages_pair_each_row(name):
    """Each row's blocks in order, two a stage, an odd row's last block
    beside a zero one at column -1; each image is the block's 32-byte
    window of W: the block at K offset (bw * col) % 16, zero elsewhere."""
    _, W, blk, _, _ = _case(name)
    bsr = build_bsr_int8_direct(W, blk)
    stages, sptr, scol = small_stages(bsr)
    rp = bsr.row_ptr
    assert stages.shape == (sptr[-1], 1024) and scol.shape == (sptr[-1], 2)
    images = stages.reshape(-1, 2, 16, WIN)
    for br in range(bsr.num_block_rows):
        n = rp[br + 1] - rp[br]
        assert sptr[br + 1] - sptr[br] == (n + 1) // 2
        for i in range(n):
            st, half = sptr[br] + i // 2, i % 2
            c = bsr.col_idx[rp[br] + i]
            assert scol[st, half] == c
            d = blk * c % 16
            assert d + blk <= WIN
            want = np.zeros((16, WIN), np.int8)
            want[:blk, d:d + blk] = bsr.data[rp[br] + i]
            np.testing.assert_array_equal(images[st, half], want)
        if n % 2:
            assert scol[sptr[br + 1] - 1, 1] == -1
            assert not images[sptr[br + 1] - 1, 1].any()
    packed = ops.pack_bsr(bsr, "cpu")
    counts = np.diff(sptr)
    assert packed.max_row_stages == (counts.max() if counts.size else 0)


def _swizzle32(addr):
    """Shared-memory byte ``addr`` as the 32-byte swizzle moves it: the
    16-byte chunk bit (4) XOR address bit 7."""
    return addr ^ (((addr >> 7) & 1) << 4)


def _tma_byte(dst, row, k):
    """Where a TMA box of 32-byte rows at ``dst`` (1024-byte aligned) puts
    its byte (row, k), swizzled by 32 bytes."""
    return _swizzle32(dst + WIN * row + k)


def _desc_byte(start, row, k):
    """The byte of operand (row, k) of one k32 step that ``wgmma`` reads
    through sm90::smem_desc(start, 32, 3): 32-byte rows, 8-row groups SBO
    = 256 bytes apart, the 32-byte swizzle on the address."""
    return _swizzle32(start + (row // 8) * 256 + (row % 8) * WIN + k)


@pytest.mark.parametrize("stage", [0, 3])
def test_descriptors_name_the_loaded_bytes(stage):
    """Each of a stage's four wgmmas reads its operands where the copies
    put them: block b's A box at ring_a + stage * 8192 + 4096b (rows 64h..
    for half h, the descriptor at + 2048h); the stage's W box (32 rows) at
    ring_w + stage * 1024, block b's rows from 16b (the descriptor at +
    512b)."""
    base = 1024
    ring_a, ring_w = base, base + 4 * 2 * BM * WIN
    for b in range(2):
        box = ring_a + stage * 2 * BM * WIN + b * BM * WIN
        for h in range(2):
            start = box + h * 64 * WIN
            for r in range(64):
                for k in range(WIN):
                    assert _desc_byte(start, r, k) == \
                        _tma_byte(box, 64 * h + r, k)
        wbox = ring_w + stage * 1024
        seen = set()
        for n in range(16):
            for k in range(WIN):
                got = _desc_byte(wbox + 512 * b, n, k)
                assert got == _tma_byte(wbox, 16 * b + n, k)
                seen.add(got)
        assert seen == set(range(wbox + 512 * b, wbox + 512 * (b + 1)))


@pytest.mark.parametrize("n", [0, 1, 2, 3, 7, 44, 45])
def test_split_shares_cover_each_stage_once(n):
    for split in range(1, 9):
        seen = [s for r in range(split)
                for s in _kernels.split_share(n, split, r)]
        assert seen == list(range(n))


def test_plan_splits_the_mnist_fc1_only():
    """The MNIST fc1 at 14 x 14 (one M tile, 10 block rows of about 44
    stages) splits across a cluster of two; the ResNet-18's stage-4 conv
    at batch 8 (148 tiles) does not; K % 16 != 0 and blocks wider than 16
    stay on mma_sync."""
    rng = np.random.default_rng(4)
    W = _weight(rng, 128, 9216, 14, 14, 0.85)
    packed = ops.pack_bsr(build_bsr_int8_direct(W, 14), "cpu")
    a = torch.zeros((128, 9216), dtype=torch.int8)
    assert ops.bsr_plan(a, packed) == _kernels.GemmPlan("wgmma_small", 16, 2)
    W = _weight(rng, 512, 4608, 14, 14, 0.7)
    packed = ops.pack_bsr(build_bsr_int8_direct(W, 14), "cpu")
    a = torch.zeros((8 * 49, 4608), dtype=torch.int8)
    assert ops.bsr_plan(a, packed).split == 1
    W = _weight(rng, 40, 200, 8, 8, 0.5)
    packed = ops.pack_bsr(build_bsr_int8_direct(W, 8), "cpu")
    assert ops.bsr_plan(torch.zeros((64, 200), dtype=torch.int8),
                        packed).variant == "mma_sync"
    W = _weight(rng, 48, 192, 16, 24, 0.5)
    packed = ops.pack_bsr(build_bsr_int8_direct(W, 16, 24), "cpu")
    assert packed.stages is None
    assert ops.bsr_plan(torch.zeros((64, 192), dtype=torch.int8),
                        packed).variant == "mma_sync"
