"""PyTorch port: K4's conv route (``bsr_conv2d_int8``: the zero-skip conv
of a layer in blocks of at most 16 x 16, one launch), modelled on the CPU.

The kernel runs only on a card (tests/test_torch_kernels.py holds it
against its plain version there).  Here its walk is modelled in numpy from
exactly what the kernel reads: each M tile's staged input rows (the zero-
padded input, or its every s-th row and column for a 1 x 1 conv of stride
s, images back to back, ``chunk`` bytes of slack after each pixel, filled
here with noise that a read of it would show), each pixel's top-left tap
in that tile, the gather table, and K4's small-block stage images walked
as ``conv_walk`` orders them (packed in that order and swizzled, read
where the wgmma descriptors name each operand): runs of block rows, each
column that a row of the run stores gathered once and multiplied by its
slot of the ring of column images, which starts as noise: the images of
the rows its mask names, the zero image in each row that the slot's last
column stored and this one does not.  Every gathered window byte below K
must be the patch matrix's (``im2col_nchw``), every byte past K must lie
in the staged tile, and the model's output must
equal ``bsr_conv2d_int8_plain`` bit for bit, which must equal both the
three stages it replaces and K2's plain version on the dense weight.  The
model's ResNet-18 takes the conv route at 14 x 14 blocks and the old chain
at 64 x 64.
"""

import dataclasses

import numpy as np
import pytest
import torch

from resnet_accel_tpu_torch import ops
from resnet_accel_tpu_torch.models import resnet18 as P
from resnet_accel_tpu_torch.models.resnet import (init_resnet_fp32,
                                                  quantize_resnet,
                                                  trunk_convs)
from resnet_accel_tpu_torch.ops import bsr_conv as BC
from resnet_accel_tpu_torch.ops.bsr_matmul import (CONV_WALK_ROWS,
                                                   SMALL_BLOCK, SMALL_WINDOW,
                                                   conv_walk, small_stages)
from resnet_accel_tpu_torch.ops.conv import _pads, im2col_nchw
from resnet_accel_tpu_torch.ops.epilogue import add_residual
from resnet_accel_tpu_torch.sparse import build_bsr_int8_direct

torch.set_num_threads(2)


def _i8(rng, shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


def _case(seed, N, C, H, O, k, s, pad, blk, sparsity=0.7, counts=None,
          join=False):
    """Seeded int8 x (channels-last), a [O, C*k*k] weight at blk x blk
    blocks zeroed with probability ``sparsity`` (or ``counts[br]`` kept in
    block row br), its packed BSR, bias, factors, and a residual with
    scales where ``join``."""
    rng = np.random.default_rng(seed)
    K = C * k * k
    W = _i8(rng, (O, K))
    nbr, nbc = -(-O // blk), -(-K // blk)
    keep = rng.random((nbr, nbc)) >= sparsity
    if counts is not None:
        keep[:] = False
        for br, n in enumerate(counts):
            keep[br, rng.choice(nbc, n, replace=False)] = True
    W *= np.repeat(np.repeat(keep, blk, 0), blk, 1)[:O, :K]
    x = torch.from_numpy(_i8(rng, (N, C, H, H))).contiguous(
        memory_format=torch.channels_last)
    packed = ops.pack_bsr(build_bsr_int8_direct(W, blk), "cpu", conv=True)
    bias = torch.from_numpy(rng.integers(-3000, 3000, O).astype(np.int32))
    f = torch.from_numpy((rng.uniform(0.5, 1.5, O) * 0.4 / np.sqrt(K))
                         .astype(np.float32))
    kw = dict(kernel=k, stride=s, padding=pad, relu=bool(seed % 2))
    if join:
        Ho = ops.conv._out_hw(H, H, k, s, pad)[0]
        kw["residual"] = torch.from_numpy(_i8(rng, (N, O, Ho, Ho))).contiguous(
            memory_format=torch.channels_last)
        kw["res_scales"] = tuple(float(v) for v in rng.uniform(
            0.01, 0.05, 3).astype(np.float32))
    return x, W, packed, bias, f, kw


def _staged(x, st, kernel, r0, nrows, rng):
    """The kernel's staged tile: rows r0 .. r0 + nrows of the images' staged
    rows back to back, [nrows, Ws, P] bytes, the slack after each pixel's C
    bytes noise."""
    N, C, H, W = x.shape
    xs = x.permute(0, 2, 3, 1).numpy()
    tile = rng.integers(-128, 128, (nrows, st.Ws, st.P)).astype(np.int64)
    tile[:, :, :C] = 0
    for r in range(nrows):
        n, hs = divmod(r0 + r, st.Hs)
        h = hs * st.ss - st.pad_h
        if n >= N or not 0 <= h < H:
            continue
        for ws in range(st.Ws):
            w = ws * st.ss - st.pad_w
            if 0 <= w < W:
                tile[r, ws, :C] = xs[n, h, w]
    return tile.reshape(-1)


def _model(x, packed, bias, factors, plan, *, kernel, stride, padding, relu,
           residual=None, res_scales=None):
    """The kernel's output [N, O, Ho, Wo], walked CTA by CTA as
    ``csrc/bsr_conv.cu`` does, checking each gathered window against the
    patch matrix on the way."""
    N, C, H, W = x.shape
    st = BC.conv_staging(C, H, W, kernel, stride, padding)
    M, hw = N * st.Ho * st.Wo, st.Ho * st.Wo
    O, bh, bw = packed.n_out, packed.block_h, packed.block_w
    Kdim = C * kernel * kernel
    nbr = packed.n_padded // bh
    tab = BC.conv_gather_table(C, kernel, st.Ws, st.P,
                               BC.table_length(packed.k_padded))
    # each image as the kernel's copy leaves it in shared memory, read where
    # the wgmma descriptor names operand (row, k); the last a zero image
    q = (32 * np.arange(SMALL_BLOCK)[:, None]
         + np.arange(SMALL_WINDOW)[None, :])
    images = packed.walk_images.numpy()[:, q ^ (((q >> 7) & 1) << 4)]
    rows = packed.walk_rows
    wptr, wcol = packed.walk_ptr.numpy(), packed.walk_col.numpy()
    row_ptr = packed.row_ptr.numpy()
    patches = im2col_nchw(x, kernel, stride, padding).reshape(M, -1).numpy()
    res = (None if residual is None
           else residual.permute(0, 2, 3, 1).reshape(M, O).numpy())
    out = np.zeros((M, O), np.int8)
    rng = np.random.default_rng(7)

    def srow(m):
        n = m // hw
        return n * st.Hs + (m - n * hw) // st.Wo * st.se

    for m0 in range(0, M, plan.mt):
        last = min(m0 + plan.mt, M) - 1
        r0 = srow(m0)
        nrows = srow(last) + kernel - r0
        assert nrows <= plan.stage_rows
        flat = _staged(x, st, kernel, r0, nrows, rng)
        m = np.minimum(np.arange(m0, m0 + plan.mt), last)
        n, rem = m // hw, m % hw
        oh, ow = rem // st.Wo, rem % st.Wo
        tap0 = ((n * st.Hs + oh * st.se - r0) * st.Ws * st.P
                + ow * st.se * st.P)
        live = np.arange(m0, m0 + plan.mt) <= last
        for run in range(len(wptr) - 1):
            acc = np.zeros((rows, plan.mt, SMALL_BLOCK), np.int64)
            img = row_ptr[run * rows]
            # the ring of column images as shared memory starts: noise, which
            # a row that no copy set would show in the sums
            ring = rng.integers(-128, 128, (BC.RING, rows, SMALL_BLOCK,
                                            SMALL_WINDOW))
            held = [(1 << rows) - 1] * BC.RING
            for i, e in enumerate(wcol[wptr[run]:wptr[run + 1]]):
                # the producer: each stored image to its row of the slot,
                # the zero image after them (images[nnz]) to each row the
                # slot's last column stored and this one does not
                slot, mask = i % BC.RING, e & 0xff
                put, held[slot] = mask | held[slot], mask
                for r in range(rows):
                    if (mask >> r) & 1:
                        ring[slot, r] = images[img]
                        img += 1
                    elif (put >> r) & 1:
                        ring[slot, r] = images[row_ptr[-1]]
                x0 = ((e >> 8) * bw) & ~15
                at = tap0[:, None] + tab[None, x0:x0 + SMALL_WINDOW]
                # every window byte in the tile, past K too
                assert at.min() >= 0 and at.max() < flat.size
                a = flat[at]
                ks = np.arange(x0, x0 + SMALL_WINDOW)
                inside = ks < Kdim
                assert np.array_equal(a[live][:, inside],
                                      patches[m[live]][:, ks[inside]])
                # one MMA over the slot: every row of the run
                acc += np.einsum("mk,rnk->rmn", a.astype(np.int64),
                                 ring[slot].astype(np.int64))
            for br in range(run * rows, min((run + 1) * rows, nbr)):
                n0 = br * bh
                cols = np.arange(n0, min(n0 + bh, O))
                v = acc[br - run * rows][live][:, :cols.size] + \
                    bias.numpy()[cols]
                if relu:
                    v = np.maximum(v, 0)
                q = np.clip(np.rint(v.astype(np.float32)
                                    * factors.numpy()[cols]), -128, 127)
                if res is not None:
                    s_main, s_res, s_out = (np.float32(t) for t in res_scales)
                    j = (q.astype(np.float32) * s_main
                         + res[m[live]][:, cols].astype(np.float32) * s_res)
                    q = np.maximum(np.clip(np.rint(j / s_out), -128, 127), 0)
                out[m[live][:, None], cols[None, :]] = q.astype(np.int8)
    return torch.from_numpy(out).view(N, st.Ho, st.Wo, O).permute(0, 3, 1, 2)


# (seed, N, C, H, O, kernel, stride, padding, block, counts, join): the
# basic block's 3 x 3 convs at stride 1 and 2 and its 1 x 1 downsample;
# tiles spanning several small images; C at 8-byte (chunk 8) and 4-byte
# (chunk 4) multiples; O not a multiple of the block (nor of 4: the
# residual staged byte by byte); per-side padding; a block row with none,
# one, an odd count of blocks; 8 x 8 blocks; 19 block rows (three runs of
# seven).
CASES = [
    (0, 2, 16, 10, 30, 3, 1, 1, 14, None, True),
    (1, 3, 16, 9, 28, 3, 2, 1, 14, None, False),
    (2, 2, 32, 8, 40, 1, 2, 0, 14, None, False),
    (3, 5, 8, 5, 20, 3, 1, 1, 8, None, True),
    (4, 2, 12, 7, 14, 3, 1, 1, 14, None, False),
    (5, 3, 16, 6, 64, 3, 1, 1, 14, (3, 0, 1, 2, 9), True),
    (6, 2, 16, 11, 24, 3, 2, ((1, 0), (0, 1)), 8, None, False),
    (7, 4, 24, 4, 18, 1, 1, 0, 14, (0, 1), True),
    (8, 2, 16, 6, 266, 3, 1, 1, 14, None, True),
]


@pytest.mark.parametrize("case", CASES, ids=[f"case{c[0]}" for c in CASES])
@pytest.mark.parametrize("mt", [None, 64, 128])
def test_model_matches_plain(case, mt):
    seed, N, C, H, O, k, s, pad, blk, counts, join = case
    x, W, packed, bias, f, kw = _case(seed, N, C, H, O, k, s, pad, blk,
                                      counts=counts, join=join)
    plan = ops.bsr_conv_plan(N, C, H, H, k, s, _pads(pad), join,
                             packed.walk_rows)
    if mt is not None:
        st = BC.conv_staging(C, H, H, k, s, pad)
        plan = dataclasses.replace(plan, mt=mt,
                                   stage_rows=BC._stage_rows(N, st, k, mt))
    want = ops.bsr_conv2d_int8_plain(x, packed, bias, f, **kw)
    got = _model(x, packed, bias, f, plan, **kw)
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", CASES, ids=[f"case{c[0]}" for c in CASES])
def test_plain_is_the_three_stages_and_the_dense_conv(case):
    seed, N, C, H, O, k, s, pad, blk, counts, join = case
    x, W, packed, bias, f, kw = _case(seed, N, C, H, O, k, s, pad, blk,
                                      counts=counts, join=join)
    got = ops.bsr_conv2d_int8_plain(x, packed, bias, f, **kw)
    assert got.is_contiguous(memory_format=torch.channels_last)
    # the wrapper on CPU tensors is the plain version
    assert torch.equal(ops.bsr_conv2d_int8(x, packed, bias, f, **kw), got)
    Ho = ops.conv._out_hw(H, H, k, s, pad)[0]
    a = im2col_nchw(x, k, s, pad).reshape(N * Ho * Ho, -1)
    q = ops.bsr_matmul_wt(a, packed, bias=bias, factors=f, relu=kw["relu"])
    q = q.view(N, Ho, Ho, -1).permute(0, 3, 1, 2)
    if join:
        q = add_residual(q, kw["residual"], *kw["res_scales"], relu=True)
    assert torch.equal(got, q)
    w4 = torch.from_numpy(W).reshape(O, C, k, k)
    dense = ops.conv2d_int8_plain(x, w4, bias, f, stride=s, padding=pad,
                                  relu=kw["relu"],
                                  residual=kw.get("residual"),
                                  res_scales=kw.get("res_scales"))
    assert torch.equal(got, dense)


def test_gather_table_is_im2col_order():
    """Column k of the patch matrix is x's channel k // 9 at tap (k % 9 //
    3, k % 3): the table's byte for it is that tap's, from the top-left
    one; every column past K reads the top-left tap."""
    C, Ws, P_ = 5, 7, 13
    tab = BC.conv_gather_table(C, 3, Ws, P_, 64)
    for k in range(64):
        if k < 45:
            c, kh, kw = k // 9, k % 9 // 3, k % 3
            assert tab[k] == kh * Ws * P_ + kw * P_ + c
        else:
            assert tab[k] == 0
    # a 1 x 1 conv gathers the pixel's own channels
    assert np.array_equal(BC.conv_gather_table(32, 1, 9, 40, 64)[:32],
                          np.arange(32))
    # the table covers every window a stored block can open
    assert BC.table_length(576) >= (575 // 14 * 14 & ~15) + SMALL_WINDOW


def test_stage_rows_is_the_largest_tile():
    """The plan's staged rows against a brute force over every tile."""
    for N, C, H, k, s, pad in [(3, 16, 7, 3, 1, 1), (2, 16, 14, 3, 2, 1),
                               (5, 32, 14, 1, 2, 0), (128, 512, 7, 3, 1, 1)]:
        st = BC.conv_staging(C, H, H, k, s, pad)
        M = N * st.Ho * st.Wo
        for mt in (64, 128):
            best = 0
            for m0 in range(0, M, mt):
                rows = set()
                for m in range(m0, min(m0 + mt, M)):
                    n, rem = divmod(m, st.Ho * st.Wo)
                    oh = rem // st.Wo
                    rows.update(n * st.Hs + oh * st.se + t
                                for t in range(k))
                best = max(best, max(rows) - min(rows) + 1)
            assert BC._stage_rows(N, st, k, mt) == best


def test_plan_at_resnet18_batch_128():
    """ResNet-18's 19 trunk convs at 224 x 224, batch 128, 14 x 14 blocks:
    128-pixel tiles, two CTAs an SM, up to stage 3, 64-pixel tiles in stage
    4 (its 7 x 7 images put three in a 128-pixel tile); the shared memory
    the kernel computes (the residual staged where the c2 joins one)."""
    for conv in trunk_convs(18):
        k, s = conv.kernel, conv.stride
        pad = 1 if k == 3 else 0
        join = conv.name.endswith(".c2")
        nbr = -(-conv.O // 14)
        rows = -(-nbr // -(-nbr // CONV_WALK_ROWS))
        plan = ops.bsr_conv_plan(128, conv.C, conv.H, conv.H, k, s,
                                 _pads(pad), join, rows)
        assert plan.mt == (64 if conv.stage == 4 and k == 3 else 128), conv
        assert plan.smem <= (BC.TWO_CTA_SMEM if plan.mt == 128
                             else BC.MAX_SMEM)
        st = BC.conv_staging(conv.C, conv.H, conv.H, k, s, pad)
        tile = -(-plan.stage_rows * st.Ws * st.P // 16) * 16
        assert plan.smem == (BC.head_smem(rows)
                             + max(tile, BC.PART_SMEM if plan.mt == 64
                                   else 0)
                             + (plan.mt * BC.RES_PITCH if join else 0))


@pytest.mark.parametrize("O,K,blk,sparsity", [
    (64, 576, 14, 0.7), (512, 4608, 14, 0.7), (266, 144, 14, 0.5),
    (40, 96, 8, 0.9), (30, 64, 14, 1.0)])
def test_conv_walk(O, K, blk, sparsity):
    """Each run of at most CONV_WALK_ROWS block rows (the fewest, even)
    lists the block columns its rows store, in order, once each, with the
    mask of those rows, and each stored block's image in K4's small-block
    stages, by run, column and row; run q's images start at row_ptr[q *
    rows]."""
    rng = np.random.default_rng(O + K)
    W = _i8(rng, (O, K))
    nbr, nbc = -(-O // blk), -(-K // blk)
    keep = rng.random((nbr, nbc)) >= sparsity
    W *= np.repeat(np.repeat(keep, blk, 0), blk, 1)[:O, :K]
    bsr = build_bsr_int8_direct(W, blk)
    walk_ptr, walk_col, walk_img, rows = conv_walk(bsr)
    runs = -(-nbr // rows)
    assert rows <= CONV_WALK_ROWS and runs == -(-nbr // CONV_WALK_ROWS)
    assert walk_img.size == bsr.nnz_blocks and walk_ptr[-1] == walk_col.size
    images = small_stages(bsr)[0].reshape(-1, SMALL_BLOCK, SMALL_WINDOW)
    data = np.asarray(bsr.data).reshape(-1, blk, blk)
    stored = {(br, int(c)): i for br in range(nbr)
              for i, c in enumerate(bsr.col_idx[bsr.row_ptr[br]:
                                                bsr.row_ptr[br + 1]],
                                    start=int(bsr.row_ptr[br]))}
    at = 0
    for q in range(runs):
        assert at == bsr.row_ptr[min(q * rows, nbr)]
        entries = walk_col[walk_ptr[q]:walk_ptr[q + 1]]
        assert np.all(np.diff(entries >> 8) > 0)
        want_cols = sorted({c for (br, c) in stored
                            if q * rows <= br < (q + 1) * rows})
        assert list(entries >> 8) == want_cols
        for e in entries:
            col = e >> 8
            for r in range(rows):
                br = q * rows + r
                assert bool((e >> r) & 1) == ((br, col) in stored)
                if (e >> r) & 1:
                    d = (blk * col) % 16
                    img = images[walk_img[at]]
                    assert np.array_equal(img[:blk, d:d + blk],
                                          data[stored[(br, col)]])
                    at += 1
    assert at == bsr.nnz_blocks


def _tiny_resnet18():
    fp32 = P.prune_params_blockwise(
        init_resnet_fp32(18, seed=0, num_classes=10, small_input=True),
        sparsity=0.7, block=14)
    calib = np.random.default_rng(0).normal(
        0, 1, (1, 3, 32, 32)).astype(np.float32)
    return quantize_resnet(fp32, calib, 18, 10, small_input=True)


@pytest.mark.parametrize("block,route", [(14, "bsr_conv"), (8, "bsr_conv"),
                                         (64, "chain")])
def test_routing_by_block_shape(block, route):
    """Layers in blocks of at most 16 x 16 take the conv route, larger ones
    the im2col -> K4 -> join chain, by block shape alone; both give the
    dense forward's logits."""
    dense = _tiny_resnet18()
    model = P.attach_bsr(dense, block=block, min_sparsity=0.0,
                         layer_filter=lambda name: name != "stem")
    mod = P.ResNet18Int8Module(model, "cpu")
    calls = {"bsr_conv": 0, "chain": 0}

    def conv_route(*a, **k):
        calls["bsr_conv"] += 1
        return ops.bsr_conv2d_int8(*a, **k)

    def chain(*a, **k):
        calls["chain"] += 1
        return ops.bsr_matmul_wt(*a, **k)

    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (2, 3, 32, 32)).astype(np.float32))
    with torch.inference_mode():
        got = mod._forward(x, ops.stem_conv_pool, ops.stem_conv_pool_int8,
                           ops.quantize_s2d, ops.conv2d_int8,
                           ops.matmul_int8, chain, ops.expand_add_int8,
                           conv_route)
        want = P.ResNet18Int8Module(dense, "cpu")(x)
    n_sparse = sum(qc.bsr is not None for _, qc in model.named_convs())
    assert n_sparse == 19
    other = "chain" if route == "bsr_conv" else "bsr_conv"
    assert calls[route] == n_sparse and calls[other] == 0
    assert torch.equal(got, want)


@pytest.mark.parametrize("blk,conv", [(14, False), (14, True), (8, True),
                                      (64, False), (64, True)])
def test_pack_carries_what_its_caller_reads(blk, conv):
    """A GEMM's pack of small blocks carries K4's stages and no walk; a
    conv layer's carries the route's walk (its images those stages in walk
    order, swizzled, then a zero image) and no stages; blocks over 16 x 16
    carry neither, whoever packs them."""
    rng = np.random.default_rng(blk)
    W = _i8(rng, (64, 9 * 64))
    W *= np.repeat(np.repeat(rng.random((-(-64 // blk), -(-576 // blk)))
                             >= 0.6, blk, 0), blk, 1)[:64, :576]
    bsr = build_bsr_int8_direct(W, blk)
    packed = ops.pack_bsr(bsr, "cpu", conv=conv)
    small = blk <= 16
    assert (packed.stages is not None) == (small and not conv)
    assert (packed.stage_ptr is not None) == (small and not conv)
    assert (packed.walk_images is not None) == (small and conv)
    assert torch.equal(packed.blocks, torch.from_numpy(bsr.data).reshape(
        packed.blocks.shape))
    if small and conv:
        stages = small_stages(bsr)[0].reshape(-1, 16, 32)
        walk_ptr, walk_col, walk_img, rows = conv_walk(bsr)
        q = np.arange(512)
        images = packed.walk_images.numpy()[:, q ^ (((q >> 7) & 1) << 4)]
        assert np.array_equal(images[:-1], stages[walk_img].reshape(-1, 512))
        assert not images[-1].any()
        assert np.array_equal(packed.walk_ptr.numpy(), walk_ptr)
        assert np.array_equal(packed.walk_col.numpy(), walk_col)
        assert packed.walk_rows == rows
