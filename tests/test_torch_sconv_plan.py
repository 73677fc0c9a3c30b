"""PyTorch port: K8's route by shape and a model of its Hopper walk, on the
CPU.

K8's Hopper route (``csrc/sparse_conv.cu`` on ``csrc/sm90_gemm_s8.cuh``)
is K4's stored-block walk over K2's conv windows: output block ``ob`` is
block row ``ob`` (row pointers ``o_ptr``) of a BSR weight over the conv's
patch matrix in K2's (kh, kw, c) K order, each stored block at block
column ``col``, and the kernel turns a block's K byte ``col * block_c +
wx`` into tap ``(col * block_c) // C`` and channel ``(col * block_c) % C
+ wx``, the window its TMA map in im2col mode fetches; a tile is 64
channels of one output block, each walking the block's whole list.  The
tests hold ``sparse_conv_plan``'s routes to the kernel's limits, the
packer's ``col`` to each block's own (kh, kw, cb), the 64-channel tiles
to one sum a column, the epilogue's rounding by an add of 1.5 * 2^23 to
the golden requant, and the walk itself -- K4's plain version over the
port's own ``im2col_nchw`` rows in that K order -- bit for bit to K8's
plain version and to the JAX ``sparse_conv2d_int8`` (Pallas in interpret
mode, as ``tests/test_sparse_conv.py`` runs it).  Exact: integer sums and
one IEEE f32 operation a step.  Models of the kernel, not the kernel: the
card tests ``test_sparse_conv*`` (``tests/test_torch_kernels.py``) hold
the kernel at the same shapes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from resnet_accel_tpu.ops import requant_factors
from resnet_accel_tpu.ops import sparse_conv as J
from resnet_accel_tpu_torch import cli
from resnet_accel_tpu_torch.ops import (PackedBSR, bsr_matmul_wt_plain,
                                        im2col_nchw, requantize,
                                        sparse_conv2d_int8_plain,
                                        sparse_conv_plan)
from resnet_accel_tpu_torch.sparse import (device_pack, pack_conv_bsr,
                                           tap_sparse_weight)

torch.set_num_threads(2)


def _packed(O, C, k, block_o=128, block_c=None, sparsity=0.5, seed=0):
    w = tap_sparse_weight(np.random.default_rng(seed), O, C, k, sparsity,
                          block_o, block_c)
    return w, device_pack(pack_conv_bsr(w, padding=k // 2, block_o=block_o,
                                        block_c=block_c), "cpu")


def _x(N, C, H, offset=0):
    """Int8 [N, C, H, H] in channels-last order, its base ``offset`` bytes
    past a 64-byte boundary."""
    flat = torch.zeros(N * C * H * H + 128, dtype=torch.int8)
    skip = (-flat.data_ptr()) % 64 + offset
    x = flat[skip:skip + N * C * H * H].view(N, H, H, C).permute(0, 3, 1, 2)
    assert x.is_contiguous(memory_format=torch.channels_last)
    assert x.data_ptr() % 64 == offset
    return x


# The conv sweep's four cases at 128 x 128 and the Hopper tile's limits:
# block_c 32, 64 and 128, block_o 32 to 256, c_out off the block.
@pytest.mark.parametrize("O,C,k,block_o,block_c", [
    *[(O, C, k, 128, None) for _, C, O, _, k, _, _ in cli.CONV_CASES],
    (128, 64, 3, 128, 32), (256, 128, 3, 64, 64), (512, 256, 3, 256, 128),
    (100, 128, 3, 128, None), (100, 64, 3, 32, 32), (48, 64, 1, 128, 64),
    (96, 64, 3, 8, 32)])
def test_plan_hopper_route(O, C, k, block_o, block_c):
    _, pk = _packed(O, C, k, block_o, block_c)
    plan = sparse_conv_plan(_x(1, C, 4), pk)
    assert (plan.variant, plan.bn, plan.split) == ("wgmma_tma", 64, 1)
    assert pk.block_c % 32 == 0 and pk.block_o % 8 == 0


@pytest.mark.parametrize("O,C,k,block_o,block_c,offset", [
    (256, 128, 3, 14, 16, 0),       # the reference's blocks (phase 22)
    (512, 256, 1, 14, 16, 0),
    (128, 64, 3, 128, 8, 0),        # block_c off the 32-byte K stage
    (128, 64, 3, 4, 32, 0),         # block_o off wgmma's 8-wide N step
    (36, 64, 3, 12, 32, 0),         # (their card cases)
    (40, 128, 3, 20, 64, 0),
    (256, 128, 3, 128, None, 8),    # x off 16 bytes: TMA refuses it
    (256, 128, 3, 128, None, 4)])
def test_plan_mma_sync_route(O, C, k, block_o, block_c, offset):
    _, pk = _packed(O, C, k, block_o, block_c)
    plan = sparse_conv_plan(_x(1, C, 4, offset), pk)
    assert (plan.variant, plan.bn, plan.split) == ("mma_sync", 0, 1)


def test_plan_blocks_base_off_16_bytes():
    """The blocks' base off 16 bytes (a view one block row in) takes
    mma_sync; the same blocks copied to an aligned base take the Hopper
    route."""
    _, pk = _packed(256, 128, 3, 8, 32, sparsity=0.0)
    x = _x(1, 128, 4)
    blocks = pk.blocks
    flat = torch.zeros(blocks.numel() + 128, dtype=torch.int8)
    skip = (-flat.data_ptr()) % 64 + 8
    off = flat[skip:skip + blocks.numel()].view(blocks.shape)
    off.copy_(blocks)
    pk.blocks = off
    assert sparse_conv_plan(x, pk).variant == "mma_sync"
    pk.blocks = off.clone()
    assert pk.blocks.data_ptr() % 16 == 0
    assert sparse_conv_plan(x, pk).variant == "wgmma_tma"


@pytest.mark.parametrize("O,C,k,block_o,block_c", [
    (256, 128, 3, 128, 32), (512, 256, 3, 128, 64), (256, 128, 1, 64, 64),
    (100, 64, 3, 32, 16)])
def test_col_is_k2_k_order(O, C, k, block_o, block_c):
    """Each stored block's ``col``, read through K2's (kh, kw, c) K order
    as the kernel reads it, is the block's own tap and channel block, and
    the blocks of each output block sit at distinct columns."""
    w, pk = _packed(O, C, k, block_o, block_c, sparsity=0.4, seed=O + C)
    assert pk.col.dtype == torch.int32 and pk.col.shape == (pk.nnz_source,)
    ax = pk.col.long() * block_c                # each block's first K byte
    tap, chan = ax // C, ax % C
    assert torch.equal(tap // k, pk.kh.long())
    assert torch.equal(tap % k, pk.kw.long())
    assert torch.equal(chan // block_c, pk.cb.long())
    assert torch.equal(chan % block_c, torch.zeros_like(chan))
    o_ptr = pk.o_ptr.tolist()
    for ob in range(pk.n_ob):
        cols = pk.col[o_ptr[ob]:o_ptr[ob + 1]].tolist()
        assert len(set(cols)) == len(cols)
        for i, c in zip(range(o_ptr[ob], o_ptr[ob + 1]), cols):
            t, cb = divmod(c, C // block_c)
            want = w[ob * block_o:(ob + 1) * block_o,
                     cb * block_c:(cb + 1) * block_c, t // k, t % k]
            got = pk.blocks[i].numpy()      # past c_out: the packer's zeros
            np.testing.assert_array_equal(got[:len(want)], want)
            assert not got[len(want):].any()


def hopper_walk(x, pk, *, bias=None, factors=None, relu=False, stride=1):
    """The Hopper route's sum, modelled on the CPU: K4's plain version over
    the conv's patch matrix in K2's K order, the stored blocks a BSR
    weight with ``row_ptr = o_ptr`` and ``col_idx = col``."""
    N, C, _, _ = x.shape
    k = pk.kernel
    rows = im2col_nchw(x, k, stride, pk.padding)      # (c, kh, kw) order
    Ho_Wo = rows.shape[1]
    rows = rows.reshape(N * Ho_Wo, C, k * k).transpose(1, 2)
    a = rows.reshape(N * Ho_Wo, k * k * C).contiguous()   # (kh, kw, c)
    bsr = PackedBSR(
        blocks=pk.blocks, row_ptr=pk.o_ptr, col_idx=pk.col,
        block_h=pk.block_o, block_w=pk.block_c, n_out=pk.c_out,
        k_dim=k * k * C, n_padded=pk.n_ob * pk.block_o, k_padded=k * k * C,
        nnz_source=pk.nnz_source, total_source=pk.total_source,
        max_row_blocks=int(pk.o_ptr.diff().max()))
    out = bsr_matmul_wt_plain(a, bsr, bias=bias, factors=factors, relu=relu)
    Ho = int(round(Ho_Wo ** 0.5))
    return out.view(N, Ho, Ho, -1).permute(0, 3, 1, 2)


#: The Hopper route's N tile (sparse_conv_plan's).
BN = 64


def hopper_tiles(x, pk, stride):
    """The Hopper route's int32 sums tile by tile, as ``walk_of`` (kSub)
    cuts them: output block ``br`` is ``ceil(block_o / BN)`` tiles, tile
    ``s`` holding columns ``[br * block_o + s * BN, + ncols)``, ``ncols =
    min(BN, block_o - s * BN, c_out - n0)`` (none past c_out), each
    summing the block's whole list over W rows ``blk * block_o + s * BN``
    onward of the [nnz * block_o, block_c] weight.  Every column is
    written by exactly one tile; returns the sums as [N*Ho*Wo, c_out]."""
    N, C = x.shape[:2]
    k, bo, bc = pk.kernel, pk.block_o, pk.block_c
    rows = im2col_nchw(x, k, stride, pk.padding)
    M = N * rows.shape[1]
    a = rows.reshape(M, C, k * k).transpose(1, 2).reshape(M, -1).to(
        torch.float64)                                    # (kh, kw, c)
    w = pk.blocks.reshape(-1, bc).to(torch.float64)       # [nnz * bo, bc]
    o_ptr, col = pk.o_ptr.tolist(), pk.col.tolist()
    out = torch.full((M, pk.c_out), float("nan"), dtype=torch.float64)
    n_sub = -(-bo // BN)
    for tile_n in range(pk.n_ob * n_sub):
        br, s = divmod(tile_n, n_sub)
        n0 = br * bo + s * BN
        ncols = min(BN, bo - s * BN, pk.c_out - n0)
        if ncols <= 0:
            continue                        # walks nothing, stores nothing
        acc = torch.zeros((M, BN), dtype=torch.float64)
        for blk in range(o_ptr[br], o_ptr[br + 1]):
            wy = blk * bo + n0 % bo                       # the tile's rows
            wt = torch.zeros((BN, bc), dtype=torch.float64)
            got = w[wy:wy + BN]                 # TMA zero-fills past nnz*bo
            wt[:len(got)] = got
            acc += a[:, col[blk] * bc:(col[blk] + 1) * bc] @ wt.t()
        assert torch.isnan(out[:, n0:n0 + ncols]).all()
        out[:, n0:n0 + ncols] = acc[:, :ncols]
    assert not torch.isnan(out).any()
    return out.to(torch.int32)


@pytest.mark.parametrize("O,C,k,stride,block_o,block_c", [
    (256, 64, 3, 2, 128, 32), (100, 64, 3, 1, 128, 64),
    (144, 32, 3, 1, 128, 32), (100, 64, 1, 2, 32, 32),
    (192, 64, 3, 2, 96, 32), (256, 32, 3, 1, 256, 32),
    (64, 64, 3, 1, 8, 64)])
def test_sub_tiles_sum_each_column_once(O, C, k, stride, block_o, block_c):
    """Tiles of 64 columns over output blocks of any width a multiple of
    8: each column summed once, over its own rows of each stored block,
    equal to K8's plain version."""
    w, pk = _packed(O, C, k, block_o, block_c, sparsity=0.5, seed=O + k)
    xt = torch.from_numpy(np.random.default_rng(k).integers(
        -128, 128, (2, C, 7, 7)).astype(np.int8))
    got = hopper_tiles(xt, pk, stride)
    want = sparse_conv2d_int8_plain(xt, pk, stride=stride)
    assert torch.equal(got.view(2, *want.shape[2:], O).permute(0, 3, 1, 2),
                       want)


#: 1.5 * 2^23: adding it rounds a float of magnitude <= 2^22 to an integer.
K_ROUND = np.float32(12582912.0)


def finish_bits(acc, bias, factors, relu):
    """The Hopper route's requant (``finish_bits``) in numpy float32, one
    IEEE operation a step: int32 ``acc + bias``, ReLU, one conversion to
    float, the multiply, the clamp to [-128, 127], then the add of
    1.5 * 2^23, whose bits' low byte is the int8 result."""
    x = acc + bias
    if relu:
        x = np.maximum(x, 0)
    y = x.astype(np.float32) * factors
    bits = (np.minimum(np.maximum(y, np.float32(-128)), np.float32(127))
            + K_ROUND).view(np.uint32)
    return (bits & 0xFF).astype(np.uint8).view(np.int8)


@pytest.mark.parametrize("relu", [False, True])
def test_finish_bits_is_golden_requant(relu):
    """K8's epilogue rounds by an add in place of rint and two conversions:
    the same int8 as the golden requant (``requantize``) on random sums at
    every scale, on exact halves (ties to even), on saturating values and
    on sums past 2^24, where the conversion itself rounds."""
    rng = np.random.default_rng(3)
    f = np.array([0.5, 0.25, 1 / 3, 1e-3, 7.3e-5, 2.0, 1e-7, 0.0117],
                 np.float32)
    acc = np.concatenate([
        rng.integers(-2**31 // 4, 2**31 // 4, (4096, 8)),
        rng.integers(-600, 600, (4096, 8)),
        np.arange(-1024, 1024).reshape(-1, 8) * 2 + 1,      # halves at 0.5
        rng.integers(2**24, 2**26, (256, 8)),
    ]).astype(np.int32)
    bias = rng.integers(-3000, 3000, 8).astype(np.int32)
    want = requantize(torch.from_numpy(acc), torch.from_numpy(f), relu=relu,
                      bias=torch.from_numpy(bias)).numpy()
    got = finish_bits(acc, bias, f, relu)
    np.testing.assert_array_equal(got, want)
    assert (want == 127).any() and (want == -128).any() != relu
    ties = finish_bits(np.arange(-9, 10, 2, dtype=np.int32), np.int32(0),
                       np.float32(0.5), False)       # -4.5, -3.5, ... 4.5
    np.testing.assert_array_equal(ties, [-4, -4, -2, -2, 0, 0, 2, 2, 4, 4])


def _walk_case(O, C, k, stride, H, block_o, block_c, sparsity, seed,
               requant=True, drop_block=None):
    rng = np.random.default_rng(seed)
    w = tap_sparse_weight(rng, O, C, k, sparsity, block_o, block_c)
    if drop_block is not None:              # an output block stores none
        w[drop_block * block_o:(drop_block + 1) * block_o] = 0
    x = rng.integers(-128, 128, (2, C, H, H)).astype(np.int8)
    bias = rng.integers(-3000, 3000, O).astype(np.int32)
    f = requant_factors(0.02, rng.uniform(0.001, 0.01, O).astype(np.float32),
                        0.06) if requant else None
    return w, x, bias, f


WALK_CASES = {
    "3x3_s1": dict(O=256, C=64, k=3, stride=1, H=7, block_o=128,
                   block_c=32, sparsity=0.5, seed=1),
    "3x3_s2": dict(O=128, C=128, k=3, stride=2, H=9, block_o=64,
                   block_c=64, sparsity=0.6, seed=2),
    "1x1_s2": dict(O=256, C=128, k=1, stride=2, H=8, block_o=128,
                   block_c=64, sparsity=0.5, seed=3),
    "no_stored_block": dict(O=128, C=64, k=3, stride=2, H=7, block_o=128,
                            block_c=64, sparsity=1.0, seed=4),
    "empty_output_block": dict(O=256, C=64, k=3, stride=1, H=6,
                               block_o=128, block_c=32, sparsity=0.3,
                               seed=5, drop_block=1),
    "partial_last_block": dict(O=100, C=64, k=3, stride=1, H=6,
                               block_o=32, block_c=32, sparsity=0.4, seed=6),
    "int32_out": dict(O=128, C=64, k=3, stride=2, H=8, block_o=64,
                      block_c=32, sparsity=0.5, seed=7, requant=False),
}


@pytest.mark.parametrize("name", sorted(WALK_CASES))
def test_hopper_walk_matches_plain_and_jax(name):
    c = dict(WALK_CASES[name])
    stride = c["stride"]
    w, x, bias, f = _walk_case(**c)
    O, C, k, _ = w.shape
    pack = dict(padding=k // 2, block_o=c["block_o"], block_c=c["block_c"])
    pk = device_pack(pack_conv_bsr(w, **pack), "cpu")
    if name == "no_stored_block":
        assert pk.nnz_source == 0
    if name == "empty_output_block":
        assert pk.o_ptr[1] > 0 and pk.o_ptr[1] == pk.o_ptr[2]
    if name == "partial_last_block":
        assert O % pk.block_o != 0
    tb, tf = torch.from_numpy(bias), None if f is None else torch.from_numpy(f)
    kw = dict(bias=tb, factors=tf, relu=True, stride=stride)
    xt = torch.from_numpy(x).contiguous(memory_format=torch.channels_last)
    got = hopper_walk(xt, pk, **kw)
    want = sparse_conv2d_int8_plain(xt, pk, **kw)
    assert got.dtype == want.dtype == (torch.int8 if f is not None
                                       else torch.int32)
    assert torch.equal(got, want)
    ref = np.asarray(J.sparse_conv2d_int8(
        jnp.asarray(x), J.pack_conv_bsr(w, **pack), bias=jnp.asarray(bias),
        factors=f, relu=True, stride=stride))
    np.testing.assert_array_equal(got.numpy(), ref)
    if name != "no_stored_block" and f is not None:
        assert int(want.max()) - int(want.min()) > 50
