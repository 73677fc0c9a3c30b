"""PyTorch port: each hand-written CUDA kernel against its plain PyTorch
version on the card, bit for bit (tolerance 0).

The kernels have no CPU mode, so every test here needs a card and skips
without one.  This file imports no JAX, so it also runs on a machine that
has PyTorch and a card but no JAX:

    python -m pytest --noconftest -q tests/test_torch_kernels.py
"""

import sys

import numpy as np
import pytest
import torch

from resnet_accel_tpu_torch import _kernels, ops
from resnet_accel_tpu_torch.cli import CONV_CASES
from resnet_accel_tpu_torch.models.resnet import trunk_convs
from resnet_accel_tpu_torch.ops import conv as conv_mod


def _i8(rng, shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


@pytest.fixture
def cuda():
    """The card; decided here, inside the test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _t(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _stem_k1(x, w, bias, f, scale):
    """K1 on the OIHW weight and on its packed form, each one launch: both
    the plain version's bits."""
    args = (bias, f, scale)
    want = ops.stem_conv_pool_plain(x, w, *args)
    for weight in (w, ops.pack_stem_weight(w)):
        before = _kernels.launch_counts()["stem_fused"]
        got = ops.stem_conv_pool(x, weight, *args)
        torch.cuda.synchronize()
        assert _kernels.launch_counts()["stem_fused"] == before + 1
        assert got.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(got, want)


# K1 at ResNet-18's stem, at ragged and odd sizes (the last tile short or
# full, conv outputs of odd size) and at a batch of 12 at 224 x 224: 672
# tiles, so every persistent CTA walks more than one.
@pytest.mark.parametrize("N,H,W", [(2, 224, 224), (3, 37, 50), (1, 16, 16),
                                   (1, 28, 16), (1, 31, 29), (12, 224, 224)])
def test_stem(cuda, N, H, W):
    rng = np.random.default_rng(H)
    x = rng.normal(0, 1, (N, 3, H, W)).astype(np.float32)
    w = _i8(rng, (64, 3, 7, 7))
    bias = rng.integers(-5000, 5000, 64).astype(np.int32)
    f = rng.uniform(0.001, 0.01, 64).astype(np.float32)
    if N == 12:
        tiles, ctas = ops.stem_plan(N, H, W, _kernels.sm_count(cuda))
        assert tiles > 2 * ctas
    _stem_k1(_t(x, cuda), _t(w, cuda), _t(bias, cuda), _t(f, cuda),
             float(np.abs(x).max() / 127.0))


@pytest.mark.parametrize("N,H,W", [(2, 64, 48), (1, 31, 29)])
def test_stem_saturated(cuda, N, H, W):
    """Inputs that quantize to -128 and 127 (and past them) against weights
    of -128, 127 and -127: the largest sums the int8 GEMM can form."""
    rng = np.random.default_rng(W)
    scale = 0.01
    x = rng.choice(np.float32([-1e6, -1.28, 1.27, 1e6, 0.0]),
                   (N, 3, H, W)).astype(np.float32)
    w = rng.choice(np.int8([-128, 127, -127]), (64, 3, 7, 7)).astype(np.int8)
    bias = rng.integers(-5000, 5000, 64).astype(np.int32)
    # |acc| <= 147 * 128 * 128: factors that keep the requant in range
    f = rng.uniform(2e-5, 6e-5, 64).astype(np.float32)
    _stem_k1(_t(x, cuda), _t(w, cuda), _t(bias, cuda), _t(f, cuda), scale)


@pytest.mark.parametrize("C,O,H,k,stride", [
    (64, 64, 14, 3, 1), (64, 128, 15, 3, 2), (64, 128, 14, 1, 2),
    (12, 20, 9, 3, 1), (256, 512, 7, 3, 2)])
@pytest.mark.parametrize("join", [False, True])
def test_conv(cuda, C, O, H, k, stride, join):
    rng = np.random.default_rng(C + O + k)
    cl = torch.channels_last
    x = _t(_i8(rng, (2, C, H, H)), cuda).contiguous(memory_format=cl)
    w = ops.pack_weight(_i8(rng, (O, C * k * k)), C, k, cuda)
    bias = _t(rng.integers(-3000, 3000, O).astype(np.int32), cuda)
    # acc has std ~ 74 * 74 * sqrt(C*k*k); scale it to std ~ 60
    f = _t((rng.uniform(0.5, 1.5, O) * 0.011 / np.sqrt(C * k * k)).astype(
        np.float32), cuda)
    kw = dict(stride=stride, padding=k // 2, relu=not join)
    if join:
        Ho = (H + 2 * (k // 2) - k) // stride + 1
        r = _t(_i8(rng, (2, O, Ho, Ho)), cuda).contiguous(memory_format=cl)
        kw.update(residual=r, res_scales=(0.0213, 0.0172, 0.0311))
    before = dict(_kernels.KERNELS["conv_int8"].variants)
    got = ops.conv2d_int8(x, w, bias, f, **kw)
    torch.cuda.synchronize()
    _variant_launched("conv_int8", before,
                      "wgmma_tma" if C % 32 == 0 else "mma_sync")
    want = ops.conv2d_int8_plain(x, w, bias, f, **kw)
    assert torch.equal(got, want)
    # the requant spans the int8 range, so the check is not on clipped 0s
    assert int(want.max()) - int(want.min()) > 100


def _conv_args(cuda, N, C, O, H, k, stride, join, seed):
    rng = np.random.default_rng(seed)
    cl = torch.channels_last
    x = _t(_i8(rng, (N, C, H, H)), cuda).contiguous(memory_format=cl)
    w = ops.pack_weight(_i8(rng, (O, C * k * k)), C, k, cuda)
    bias = _t(rng.integers(-3000, 3000, O).astype(np.int32), cuda)
    f = _t((rng.uniform(0.5, 1.5, O) * 0.011 / np.sqrt(C * k * k)).astype(
        np.float32), cuda)
    kw = dict(stride=stride, padding=k // 2, relu=not join)
    if join:
        Ho = (H + 2 * (k // 2) - k) // stride + 1
        r = _t(_i8(rng, (N, O, Ho, Ho)), cuda).contiguous(memory_format=cl)
        kw.update(residual=r, res_scales=(0.0213, 0.0172, 0.0311))
    return (x, w, bias, f), kw


#: Every trunk conv shape of ResNet-18 and ResNet-50 at 224 x 224 (C, O,
#: H, kernel, stride): the c1, c2, c3 and downsample convs.
TRUNK_SHAPES = sorted({tuple(c[2:]) for d in (18, 50)
                       for c in trunk_convs(d)})


# K2 on its Hopper path (TMA in im2col mode, wgmma) at every trunk conv
# shape, at batch 2 and 3 (a ragged last M tile), the join on and off.
@pytest.mark.parametrize("C,O,H,k,stride", TRUNK_SHAPES)
@pytest.mark.parametrize("N", [2, 3])
@pytest.mark.parametrize("join", [False, True])
def test_conv_trunk_shapes(cuda, C, O, H, k, stride, N, join):
    args, kw = _conv_args(cuda, N, C, O, H, k, stride, join,
                          C + O + H + k + N)
    before = dict(_kernels.KERNELS["conv_int8"].variants)
    got = ops.conv2d_int8(*args, **kw)
    torch.cuda.synchronize()
    _variant_launched("conv_int8", before, "wgmma_tma")
    want = ops.conv2d_int8_plain(*args, **kw)
    assert torch.equal(got, want)
    assert int(want.max()) - int(want.min()) > 100


# The served batch's tile counts: a persistent CTA walks many tiles, at
# ResNet-18's stage-1 and stage-2 shapes (batch 32: 784 and 196 M tiles on
# at most 132 CTAs a wave), the join on.
@pytest.mark.parametrize("C,O,H,k,stride", [(64, 64, 56, 3, 1),
                                            (128, 128, 28, 3, 1),
                                            (64, 128, 56, 1, 2)])
def test_conv_many_tiles_per_cta(cuda, C, O, H, k, stride):
    args, kw = _conv_args(cuda, 32, C, O, H, k, stride, True, C + O + H)
    before = dict(_kernels.KERNELS["conv_int8"].variants)
    got = ops.conv2d_int8(*args, **kw)
    torch.cuda.synchronize()
    _variant_launched("conv_int8", before, "wgmma_tma")
    assert torch.equal(got, ops.conv2d_int8_plain(*args, **kw))


# Both N tiles of the Hopper path at ResNet-18's trunk shapes: the one
# ``conv_tile_n`` picks and the other.
@pytest.mark.parametrize("C,O,H,k,stride", sorted(
    {tuple(c[2:]) for c in trunk_convs(18)}))
@pytest.mark.parametrize("join", [False, True])
def test_conv_other_tile(cuda, monkeypatch, C, O, H, k, stride, join):
    other = 192 - conv_mod.conv_tile_n(O, k * k * C)
    monkeypatch.setattr(conv_mod, "conv_tile_n", lambda *_: other)
    args, kw = _conv_args(cuda, 3, C, O, H, k, stride, join, C + O + H)
    got = ops.conv2d_int8(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, ops.conv2d_int8_plain(*args, **kw))


def test_conv_saturated(cuda):
    """Every input and weight -128 at C_in = 2048 (ResNet-50's stage-4 c1
    is 1x1 from 2048 channels): acc = 2^25 + bias, past the integers f32
    holds exactly, so float(acc) rounds (to nearest even) on both sides."""
    rng = np.random.default_rng(11)
    C, O, cl = 2048, 512, torch.channels_last
    x = torch.full((2, C, 7, 7), -128, dtype=torch.int8,
                   device=cuda).contiguous(memory_format=cl)
    w = ops.pack_weight(np.full((O, C), -128, np.int8), C, 1, cuda)
    bias = _t(rng.integers(-3000, 3000, O).astype(np.int32), cuda)
    f = _t((rng.uniform(0.5, 1.5, O) * 100 / 2**25).astype(np.float32),
           cuda)
    before = dict(_kernels.KERNELS["conv_int8"].variants)
    got = ops.conv2d_int8(x, w, bias, f, relu=True)
    torch.cuda.synchronize()
    _variant_launched("conv_int8", before, "wgmma_tma")
    assert torch.equal(got, ops.conv2d_int8_plain(x, w, bias, f, relu=True))


def test_conv_refuses_nchw_input(cuda):
    x = torch.zeros(1, 4, 5, 5, dtype=torch.int8, device=cuda)
    w = ops.pack_weight(np.zeros((4, 36), np.int8), 4, 3, cuda)
    v = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="channels_last"):
        ops.conv2d_int8(x, w, v, v.float(), padding=1)


def _variant_launched(name, before, variant):
    """One launch of ``name`` since ``before`` (its variant counts), on
    ``variant``."""
    after = dict(_kernels.KERNELS[name].variants)
    grew = {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}
    assert grew == {variant: 1}, grew


# K3 at the served shapes (ResNet-18's and ResNet-50's fc, the MNIST CNN's
# fc1 dense and fc2, N = 10 padded by TMA) and the ragged ones (K % 16 != 0:
# the staged variant), with b as the .t() view of a row-major [N, K] (the
# served layout, no copy) and as a row-major [K, N] (one copy).
@pytest.mark.parametrize("M,K,N", [(128, 512, 1000), (5, 37, 19),
                                   (70, 129, 65), (128, 2048, 1000),
                                   (128, 9216, 128), (128, 128, 10),
                                   (20000, 512, 1000)])
@pytest.mark.parametrize("requant", [False, True])
@pytest.mark.parametrize("layout", ["nk_view", "kn"])
def test_matmul(cuda, M, K, N, requant, layout):
    rng = np.random.default_rng(M + K)
    a, w = _t(_i8(rng, (M, K)), cuda), _t(_i8(rng, (N, K)), cuda)
    b = w.t() if layout == "nk_view" else w.t().contiguous()
    bias = _t(rng.integers(-2000, 2000, N).astype(np.int32), cuda)
    f = (_t(rng.uniform(1e-5, 1e-3, N).astype(np.float32), cuda)
         if requant else None)
    before = dict(_kernels.KERNELS["matmul_int8"].variants)
    got = ops.matmul_int8(a, b, bias=bias, factors=f, relu=True)
    torch.cuda.synchronize()
    _variant_launched("matmul_int8", before,
                      "wgmma_tma" if K % 16 == 0 else "wgmma_ld")
    assert torch.equal(
        got, ops.matmul_int8_plain(a, b, bias=bias, factors=f, relu=True))


@pytest.mark.parametrize("M,K,N", [(128, 2048, 1000), (70, 129, 65)])
@pytest.mark.parametrize("split", [1, 2, 4, 8])
def test_matmul_cluster_splits(cuda, monkeypatch, M, K, N, split):
    """K3 at every cluster split the kernel takes, forced: the TMA and the
    staged variant sum the same bits."""
    rng = np.random.default_rng(K + split)
    a, w = _t(_i8(rng, (M, K)), cuda), _t(_i8(rng, (N, K)), cuda)
    bias = _t(rng.integers(-2000, 2000, N).astype(np.int32), cuda)
    f = _t(rng.uniform(1e-5, 1e-3, N).astype(np.float32), cuda)
    _force_split(monkeypatch, "matmul_int8", split)
    for kw in (dict(bias=bias), dict(bias=bias, factors=f, relu=True)):
        before = dict(_kernels.KERNELS["matmul_int8"].variants)
        got = ops.matmul_int8(a, w.t(), **kw)
        torch.cuda.synchronize()
        _variant_launched("matmul_int8", before,
                          "wgmma_tma" if K % 16 == 0 else "wgmma_ld")
        assert torch.equal(got, ops.matmul_int8_plain(a, w.t(), **kw))


def test_matmul_unaligned_base(cuda):
    """K % 16 == 0 but A's base off 16 bytes: TMA refuses it, the staged
    variant takes it."""
    rng = np.random.default_rng(3)
    M, K, N = 128, 512, 1000
    buf = _t(_i8(rng, (M * K + 16,)), cuda)
    a = buf[1:1 + M * K].view(M, K)
    b = _t(_i8(rng, (N, K)), cuda).t()
    before = dict(_kernels.KERNELS["matmul_int8"].variants)
    got = ops.matmul_int8(a, b)
    torch.cuda.synchronize()
    _variant_launched("matmul_int8", before, "wgmma_ld")
    assert torch.equal(got, ops.matmul_int8_plain(a, b))


def test_matmul_saturated(cuda):
    """Every input and weight -128 at K 2048: acc = 2^25 + bias, past the
    integers f32 holds exactly, so float(acc) rounds on both sides."""
    rng = np.random.default_rng(12)
    M, K, N = 128, 2048, 1000
    a = torch.full((M, K), -128, dtype=torch.int8, device=cuda)
    b = torch.full((N, K), -128, dtype=torch.int8, device=cuda).t()
    bias = _t(rng.integers(-3000, 3000, N).astype(np.int32), cuda)
    f = _t((rng.uniform(0.5, 1.5, N) * 100 / 2**25).astype(np.float32),
           cuda)
    for kw in (dict(bias=bias), dict(bias=bias, factors=f, relu=True)):
        before = dict(_kernels.KERNELS["matmul_int8"].variants)
        got = ops.matmul_int8(a, b, **kw)
        torch.cuda.synchronize()
        _variant_launched("matmul_int8", before, "wgmma_tma")
        assert torch.equal(got, ops.matmul_int8_plain(a, b, **kw))


def test_divide_by_device_scalar_is_ieee(cuda):
    """The plain versions divide by a float32 tensor on the device, which
    must be the IEEE quotient (not a multiply by the reciprocal)."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 50, 1 << 22).astype(np.float32)
    s = np.float32(0.0311)
    got = (_t(x, cuda) / ops.epilogue.scalar_f32(float(s), cuda)).cpu()
    np.testing.assert_array_equal(got.numpy(), x / s)


def _bsr_case(cuda, M, K, N, block, sparsity, seed):
    """Random int8 A [M, K] on the card and W [N, K] with each block x
    block tile zeroed with probability ``sparsity``, packed as BSR."""
    from resnet_accel_tpu_torch.sparse import build_bsr_int8_direct
    rng = np.random.default_rng(seed)
    W = _i8(rng, (N, K))
    nbr, nbc = -(-N // block), -(-K // block)
    mask = np.repeat(np.repeat(rng.random((nbr, nbc)) < sparsity, block, 0),
                     block, 1)[:N, :K]
    W[mask] = 0
    gen = torch.Generator(device=cuda).manual_seed(seed)
    a = torch.randint(-128, 128, (M, K), generator=gen, device=cuda,
                      dtype=torch.int8)
    bias = _t(rng.integers(-3000, 3000, N).astype(np.int32), cuda)
    # acc has std ~ 74 * 74 * sqrt(K); scale it to std ~ 60
    f = _t((rng.uniform(0.5, 1.5, N) * 0.011 / np.sqrt(K)).astype(
        np.float32), cuda)
    return a, ops.pack_bsr(build_bsr_int8_direct(W, block), cuda), bias, f


@pytest.mark.parametrize("M,K,N,block", [
    (401408, 576, 64, 128), (128, 9216, 128, 128), (5, 37, 19, 32)])
@pytest.mark.parametrize("sparsity", [0.0, 0.7, 0.9])
@pytest.mark.parametrize("requant", [False, True])
def test_bsr_matmul(cuda, M, K, N, block, sparsity, requant):
    a, packed, bias, f = _bsr_case(cuda, M, K, N, block, sparsity, M + K)
    kw = dict(bias=bias, factors=f if requant else None, relu=requant)
    before = _kernels.launch_counts()["bsr_matmul"]
    variants = dict(_kernels.KERNELS["bsr_matmul"].variants)
    got = ops.bsr_matmul_wt(a, packed, **kw)
    torch.cuda.synchronize()
    assert _kernels.launch_counts()["bsr_matmul"] == before + 1
    # K = 37 is off TMA's 16-byte rows: the mma_sync path
    _variant_launched("bsr_matmul", variants,
                      "wgmma_tma" if K % 16 == 0 else "mma_sync")
    if N == 64:     # n_out 64 inside block_h 128: a 64-column N tile
        assert ops.bsr_plan(a, packed).bn == 64
    want = ops.bsr_matmul_wt_plain(a, packed, **kw)
    assert got.dtype == want.dtype and torch.equal(got, want)


def _force_split(monkeypatch, module, split):
    """Make the wrapper in ops' ``module`` launch clusters of ``split``
    (None: the wrapper's own choice)."""
    if split is not None:
        wrapper = sys.modules[f"resnet_accel_tpu_torch.ops.{module}"]
        monkeypatch.setattr(wrapper, "cluster_split",
                            lambda *_a, **_k: split)


@pytest.mark.parametrize("full_row", [False, True])
@pytest.mark.parametrize("split", [None, 1, 4, 8])
def test_bsr_matmul_cluster_split(cuda, monkeypatch, full_row, split):
    """MNIST fc1's shape, M 128, K 9216, N 128 at 0.9: one M tile and one
    block row, so the row's stored blocks are split across a cluster (of
    two by the wrapper's choice; 1, 4 and 8 forced); with ``full_row`` a
    second block row stores all 72 blocks."""
    from resnet_accel_tpu_torch.sparse import build_bsr_int8_direct
    rng = np.random.default_rng(21)
    M, K = 128, 9216
    W = _i8(rng, (128, K))
    W[np.repeat(np.repeat(rng.random((1, 72)) < 0.9, 128, 0), 128, 1)] = 0
    if full_row:
        W = np.concatenate([W, _i8(rng, (128, K))])
    packed = ops.pack_bsr(build_bsr_int8_direct(W, 128), cuda)
    a = _t(_i8(rng, (M, K)), cuda)
    bias = _t(rng.integers(-3000, 3000, W.shape[0]).astype(np.int32), cuda)
    f = _t((rng.uniform(0.5, 1.5, W.shape[0]) * 0.011 / np.sqrt(K)).astype(
        np.float32), cuda)
    assert ops.bsr_plan(a, packed, _kernels.sm_count(cuda)).split == 2
    _force_split(monkeypatch, "bsr_matmul", split)
    for kw in (dict(), dict(bias=bias, factors=f, relu=True)):
        variants = dict(_kernels.KERNELS["bsr_matmul"].variants)
        got = ops.bsr_matmul_wt(a, packed, **kw)
        torch.cuda.synchronize()
        _variant_launched("bsr_matmul", variants, "wgmma_tma")
        assert torch.equal(got, ops.bsr_matmul_wt_plain(a, packed, **kw))
    dense = a.cpu().to(torch.int64) @ torch.from_numpy(W).to(torch.int64).t()
    assert torch.equal(ops.bsr_matmul_wt(a, packed).cpu().to(torch.int64),
                       dense)


# The Hopper path at every N tile (64, 128, 256) and K box (128, 64, 32
# bytes; 96-wide blocks take three 32-byte boxes), blocks shorter than
# the tile (8 rows: the box reads the next blocks' rows, whose columns are
# not stored), ragged M, N and K.
@pytest.mark.parametrize("M,K,N,bh,bw", [
    (300, 576, 200, 128, 128), (200, 512, 512, 256, 128),
    (130, 448, 192, 64, 64), (70, 160, 96, 32, 32), (129, 256, 44, 8, 32),
    (100, 288, 100, 24, 96), (40000, 1152, 256, 128, 128),
    (20000, 512, 512, 256, 128)])
@pytest.mark.parametrize("requant", [False, True])
def test_bsr_matmul_sm90_shapes(cuda, M, K, N, bh, bw, requant):
    from resnet_accel_tpu_torch.sparse import build_bsr_int8_direct
    rng = np.random.default_rng(M + K + bh)
    W = _i8(rng, (N, K))
    nbr, nbc = -(-N // bh), -(-K // bw)
    W[np.repeat(np.repeat(rng.random((nbr, nbc)) < 0.5, bh, 0), bw,
                1)[:N, :K]] = 0
    packed = ops.pack_bsr(build_bsr_int8_direct(W, bh, bw), cuda)
    a = _t(_i8(rng, (M, K)), cuda)
    bias = _t(rng.integers(-3000, 3000, N).astype(np.int32), cuda)
    f = _t((rng.uniform(0.5, 1.5, N) * 0.011 / np.sqrt(K)).astype(
        np.float32), cuda)
    kw = dict(bias=bias, factors=f if requant else None, relu=requant)
    variants = dict(_kernels.KERNELS["bsr_matmul"].variants)
    got = ops.bsr_matmul_wt(a, packed, **kw)
    torch.cuda.synchronize()
    _variant_launched("bsr_matmul", variants, "wgmma_tma")
    assert torch.equal(got, ops.bsr_matmul_wt_plain(a, packed, **kw))
    if not requant:
        dense = a.cpu().to(torch.int64) @ torch.from_numpy(W).to(
            torch.int64).t() + bias.cpu()
        assert torch.equal(got.cpu().to(torch.int64), dense)


def test_bsr_matmul_empty_block_row(cuda):
    """A block row with no stored block still writes requant(relu(bias))."""
    a, packed, bias, f = _bsr_case(cuda, 300, 256, 384, 128, 0.0, 7)
    dense = packed.blocks.cpu().numpy()
    from resnet_accel_tpu_torch.sparse import BSRMatrix
    row_ptr = packed.row_ptr.cpu().numpy()
    keep = np.r_[0:row_ptr[1], row_ptr[2]:row_ptr[3]]  # drop block row 1
    bsr = BSRMatrix(data=dense[keep],
                    row_ptr=np.array([0, row_ptr[1], row_ptr[1],
                                      row_ptr[1] + row_ptr[3] - row_ptr[2]],
                                     np.int32),
                    col_idx=packed.col_idx.cpu().numpy()[keep],
                    shape=(384, 256), block_h=128, block_w=128)
    bsr.validate()
    packed = ops.pack_bsr(bsr, cuda)
    variants = dict(_kernels.KERNELS["bsr_matmul"].variants)
    got = ops.bsr_matmul_wt(a, packed, bias=bias, factors=f, relu=True)
    torch.cuda.synchronize()
    _variant_launched("bsr_matmul", variants, "wgmma_tma")
    assert torch.equal(got, ops.bsr_matmul_wt_plain(
        a, packed, bias=bias, factors=f, relu=True))
    empty = ops.requantize(bias[128:256].clamp_min(0), f[128:256])
    assert torch.equal(got[:, 128:256], empty.expand(300, -1))


# Any block shape: the reference's 14 x 14, 8 x 8, 16 x 24, and widths of
# 16 and 48 (whole 16-byte chunks, with K aligned or not), with M, N and K
# ragged against the blocks and N not a multiple of block_h, so the masked
# K tails and the slice that ends inside a block row are met.  Blocks of
# at most 16 x 16 with K % 16 == 0 take the small-block path, the rest
# mma_sync (bsr_plan).
@pytest.mark.parametrize("M,K,N,bh,bw", [
    (300, 9216, 128, 14, 14), (77, 203, 131, 14, 14), (130, 100, 37, 8, 8),
    (129, 200, 70, 16, 24), (64, 192, 40, 8, 16), (70, 200, 50, 16, 48)])
@pytest.mark.parametrize("requant", [False, True])
def test_bsr_matmul_block_shapes(cuda, M, K, N, bh, bw, requant):
    from resnet_accel_tpu_torch.sparse import build_bsr_int8_direct
    rng = np.random.default_rng(M + K + bw)
    W = _i8(rng, (N, K))
    nbr, nbc = -(-N // bh), -(-K // bw)
    W[np.repeat(np.repeat(rng.random((nbr, nbc)) < 0.6, bh, 0), bw,
                1)[:N, :K]] = 0
    packed = ops.pack_bsr(build_bsr_int8_direct(W, bh, bw), cuda)
    a = _t(_i8(rng, (M, K)), cuda)
    bias = _t(rng.integers(-3000, 3000, N).astype(np.int32), cuda)
    f = _t((rng.uniform(0.5, 1.5, N) * 0.011 / np.sqrt(K)).astype(
        np.float32), cuda)
    kw = dict(bias=bias, factors=f if requant else None, relu=requant)
    before = _kernels.launch_counts()["bsr_matmul"]
    variants = dict(_kernels.KERNELS["bsr_matmul"].variants)
    got = ops.bsr_matmul_wt(a, packed, **kw)
    torch.cuda.synchronize()
    assert _kernels.launch_counts()["bsr_matmul"] == before + 1
    _variant_launched("bsr_matmul", variants,
                      "wgmma_small" if bh <= 16 and bw <= 16 and K % 16 == 0
                      else "mma_sync")
    want = ops.bsr_matmul_wt_plain(a, packed, **kw)
    assert got.dtype == want.dtype and torch.equal(got, want)
    if not requant:     # the dense product of the same weights
        dense = a.cpu().to(torch.int64) @ torch.from_numpy(W).to(
            torch.int64).t() + bias.cpu()
        assert torch.equal(got.cpu().to(torch.int64), dense)


def _small_case(rng, dev, M, K, N, blk, sparsity, counts=None):
    """int8 A [M, K] and W [N, K] at blk x blk blocks zeroed with
    probability ``sparsity`` (or ``counts[br]`` blocks kept in block row
    br), with bias and requant factors, on ``dev``."""
    from resnet_accel_tpu_torch.sparse import build_bsr_int8_direct
    W = _i8(rng, (N, K))
    nbr, nbc = -(-N // blk), -(-K // blk)
    keep = rng.random((nbr, nbc)) >= sparsity
    if counts is not None:
        keep[:] = False
        for br, n in enumerate(counts):
            keep[br, rng.choice(nbc, n, replace=False)] = True
    W *= np.repeat(np.repeat(keep, blk, 0), blk, 1)[:N, :K]
    return (_t(_i8(rng, (M, K)), dev), W,
            _t(rng.integers(-3000, 3000, N).astype(np.int32), dev),
            _t((rng.uniform(0.5, 1.5, N) * 0.011 / np.sqrt(K)).astype(
                np.float32), dev))


# The small-block path (wgmma_small) at the served 14 x 14 shapes: the
# MNIST fc1 (one M tile, split across a cluster), the 2048 GEMM, the
# ResNet-18's stage-1 and stage-4 convs at batch 8 (K 576 and 4608) and a
# 1 x 1 downsample (K 64); at 8 x 8; rows of zero, one and an odd count of
# blocks; ragged M and N; a block row with no stored block.
@pytest.mark.parametrize("M,K,N,blk,sparsity,counts", [
    (128, 9216, 128, 14, 0.87, None), (512, 2048, 2048, 14, 0.7, None),
    (25088, 576, 64, 14, 0.7, None), (392, 4608, 512, 14, 0.7, None),
    (6272, 64, 128, 14, 0.7, None), (300, 208, 131, 14, 0.0, None),
    (77, 208, 70, 14, None, (3, 0, 1, 2, 15)), (130, 208, 37, 8, 0.5, None),
    (64, 96, 40, 8, None, (1, 0, 5, 12, 2)), (129, 256, 44, 14, 1.0, None)])
@pytest.mark.parametrize("requant", [False, True])
def test_bsr_matmul_small(cuda, M, K, N, blk, sparsity, counts, requant):
    from resnet_accel_tpu_torch.sparse import build_bsr_int8_direct
    rng = np.random.default_rng(M + K + blk)
    a, W, bias, f = _small_case(rng, cuda, M, K, N, blk, sparsity or 0.0,
                                counts)
    packed = ops.pack_bsr(build_bsr_int8_direct(W, blk), cuda)
    kw = dict(bias=bias, factors=f if requant else None, relu=requant)
    assert ops.bsr_plan(a, packed, _kernels.sm_count(cuda)).variant == \
        "wgmma_small"
    before = _kernels.launch_counts()["bsr_matmul"]
    variants = dict(_kernels.KERNELS["bsr_matmul"].variants)
    got = ops.bsr_matmul_wt(a, packed, **kw)
    torch.cuda.synchronize()
    assert _kernels.launch_counts()["bsr_matmul"] == before + 1
    _variant_launched("bsr_matmul", variants, "wgmma_small")
    want = ops.bsr_matmul_wt_plain(a, packed, **kw)
    assert got.dtype == want.dtype and torch.equal(got, want)
    if not requant and M <= 512:    # the dense product of the same weights
        dense = a.cpu().to(torch.int64) @ torch.from_numpy(W).to(
            torch.int64).t() + bias.cpu()
        assert torch.equal(got.cpu().to(torch.int64), dense)


@pytest.mark.parametrize("split", [None, 1, 2, 4, 8])
def test_bsr_matmul_small_cluster_split(cuda, monkeypatch, split):
    """The MNIST fc1 at 14 x 14 with each cluster split forced (2 by the
    wrapper's choice), and a block row with no stored block: every split
    sums the same bits."""
    from resnet_accel_tpu_torch.sparse import build_bsr_int8_direct
    rng = np.random.default_rng(31)
    a, W, bias, f = _small_case(rng, cuda, 128, 9216, 128, 14, 0.87)
    W[28:42] = 0                       # block row 2 stores nothing
    packed = ops.pack_bsr(build_bsr_int8_direct(W, 14), cuda)
    assert packed.stage_ptr[2] == packed.stage_ptr[3]
    assert ops.bsr_plan(a, packed, _kernels.sm_count(cuda)).split == 2
    _force_split(monkeypatch, "bsr_matmul", split)
    for kw in (dict(), dict(bias=bias, factors=f, relu=True)):
        variants = dict(_kernels.KERNELS["bsr_matmul"].variants)
        got = ops.bsr_matmul_wt(a, packed, **kw)
        torch.cuda.synchronize()
        _variant_launched("bsr_matmul", variants, "wgmma_small")
        assert torch.equal(got, ops.bsr_matmul_wt_plain(a, packed, **kw))
    dense = a.cpu().to(torch.int64) @ torch.from_numpy(W).to(torch.int64).t()
    assert torch.equal(ops.bsr_matmul_wt(a, packed).cpu().to(torch.int64),
                       dense)


def _conv_route_case(rng, dev, N, C, O, H, k, s, blk, sparsity=0.7,
                     counts=None, join=False, odd_residual=False):
    """x [N, C, H, H] int8 channels-last, a [O, C*k*k] weight at blk x blk
    blocks zeroed with probability ``sparsity`` (or ``counts[br]`` kept in
    block row br) packed as BSR, bias, factors and, where ``join``, a
    residual (its base one byte off an even address where
    ``odd_residual``) with scales: the keywords of ``bsr_conv2d_int8``."""
    from resnet_accel_tpu_torch.sparse import build_bsr_int8_direct
    cl = torch.channels_last
    K = C * k * k
    W = _i8(rng, (O, K))
    nbr, nbc = -(-O // blk), -(-K // blk)
    keep = rng.random((nbr, nbc)) >= sparsity
    if counts is not None:
        keep[:] = False
        for br, n in enumerate(counts):
            keep[br, rng.choice(nbc, n, replace=False)] = True
    W *= np.repeat(np.repeat(keep, blk, 0), blk, 1)[:O, :K]
    pad = k // 2
    Ho = (H + 2 * pad - k) // s + 1
    x = torch.randint(-128, 128, (N, H, H, C), dtype=torch.int8,
                      device=dev).permute(0, 3, 1, 2)
    kw = dict(kernel=k, stride=s, padding=pad, relu=not join)
    if join:
        flat = torch.randint(-128, 128, (N * Ho * Ho * O + 1,),
                             dtype=torch.int8, device=dev)
        flat = flat[1:] if odd_residual else flat[:-1]
        kw["residual"] = flat.view(N, Ho, Ho, O).permute(0, 3, 1, 2)
        assert kw["residual"].is_contiguous(memory_format=cl)
        kw["res_scales"] = tuple(float(v) for v in rng.uniform(
            0.01, 0.05, 3).astype(np.float32))
    return (x, ops.pack_bsr(build_bsr_int8_direct(W, blk), dev, conv=True),
            _t(rng.integers(-3000, 3000, O).astype(np.int32), dev),
            _t((rng.uniform(0.5, 1.5, O) * 0.4 / np.sqrt(K)).astype(
                np.float32), dev), kw)


def _conv_route(args, kw):
    """One launch of K4's conv route on its variant, bit for bit its plain
    version."""
    variants = dict(_kernels.KERNELS["bsr_conv"].variants)
    k4 = _kernels.launch_counts()["bsr_matmul"]
    got = ops.bsr_conv2d_int8(*args, **kw)
    torch.cuda.synchronize()
    _variant_launched("bsr_conv", variants, "wgmma_gather")
    assert _kernels.launch_counts()["bsr_matmul"] == k4
    assert got.is_contiguous(memory_format=torch.channels_last)
    want = ops.bsr_conv2d_int8_plain(*args, **kw)
    assert got.shape == want.shape and torch.equal(got, want)


# K4's conv route at each of ResNet-18's 19 trunk convs at 224 x 224, 14 x
# 14 blocks at 0.7, batches of 2 and of 128: 3 x 3 at stride 1 and 2, the
# 1 x 1 stride-2 downsamples, C 64-512, O 64 (not a multiple of 14);
# each c2 with and without the residual join.
R18_CONVS = trunk_convs(18)


@pytest.mark.parametrize("conv", R18_CONVS, ids=[c.name for c in R18_CONVS])
@pytest.mark.parametrize("N", [2, 128])
def test_bsr_conv_resnet18(cuda, conv, N):
    rng = np.random.default_rng(N + conv.C + conv.O + conv.H + conv.kernel)
    for join in sorted({False, conv.name.endswith(".c2")}):
        x, packed, bias, f, kw = _conv_route_case(
            rng, cuda, N, conv.C, conv.O, conv.H, conv.kernel, conv.stride,
            14, join=join)
        _conv_route((x, packed, bias, f), kw)


# Odd, empty and one-block rows (O 64: the last row 8 high), 8 x 8 blocks
# at a batch of 2 and of 128, C at 8- and 4-byte multiples (staged in 8-
# and 4-byte copies), a tile of 5 x 5 images, a residual at an odd
# address (byte stores), a weight that stores no block.
@pytest.mark.parametrize("N,C,O,H,k,s,blk,sparsity,counts,join,odd", [
    (2, 64, 64, 56, 3, 1, 14, None, (3, 0, 1, 2, 15), True, False),
    (128, 64, 64, 56, 3, 1, 14, None, (3, 0, 1, 2, 15), True, False),
    (2, 64, 64, 56, 3, 1, 8, 0.7, None, True, False),
    (128, 128, 128, 28, 3, 2, 8, 0.7, None, False, False),
    (128, 512, 512, 7, 3, 1, 8, 0.7, None, True, False),
    (2, 256, 512, 14, 1, 2, 8, 0.7, None, False, False),
    (3, 16, 30, 10, 3, 1, 14, 0.5, None, True, False),
    (2, 12, 14, 7, 3, 1, 14, 0.3, None, False, False),
    (5, 64, 20, 5, 3, 1, 8, 0.6, None, True, False),
    (2, 64, 64, 28, 3, 1, 14, 0.7, None, True, True),
    (2, 64, 64, 28, 3, 1, 14, 1.0, None, True, False)])
def test_bsr_conv_shapes(cuda, N, C, O, H, k, s, blk, sparsity, counts, join,
                         odd):
    rng = np.random.default_rng(N + C + O + H + blk)
    x, packed, bias, f, kw = _conv_route_case(
        rng, cuda, N, C, O, H, k, s, blk, sparsity or 0.0, counts, join, odd)
    _conv_route((x, packed, bias, f), kw)


def test_bsr_conv_resnet18_forward(cuda):
    """The 14 x 14 ResNet-18 at 64 x 64: each of its 19 convs one launch
    of the conv route, K4 none; logits equal the plain path's, and the
    same model at 128 x 128 blocks still runs K4."""
    from resnet_accel_tpu_torch.models.resnet18 import (
        ResNet18Int8Module, attach_bsr, init_resnet18_fp32,
        prune_params_blockwise, quantize_resnet18)
    rng = np.random.default_rng(5)
    params = prune_params_blockwise(init_resnet18_fp32(seed=0,
                                                       num_classes=10),
                                    0.7, block=14)
    model = quantize_resnet18(params, rng.normal(0, 1, (2, 3, 64, 64)).astype(
        np.float32), 10)
    x = _t(rng.normal(0, 1, (4, 3, 64, 64)).astype(np.float32), cuda)
    for block, route in ((14, "bsr_conv"), (128, "bsr_matmul")):
        mod = ResNet18Int8Module(attach_bsr(model, block=block,
                                            min_sparsity=0.0,
                                            layer_filter=lambda n: n != "stem"),
                                 cuda)
        with torch.inference_mode():
            _kernels.reset_launch_counts()
            got = mod(x)
            torch.cuda.synchronize()
            counts = _kernels.launch_counts()
            other = "bsr_matmul" if route == "bsr_conv" else "bsr_conv"
            assert counts[route] == 19 and counts[other] == 0, counts
            if route == "bsr_conv":
                assert _kernels.variant_counts()["bsr_conv"] == {
                    "wgmma_gather": 19}
            assert torch.equal(got, mod.forward_plain(x))


# The four c3 shapes of ResNet-50 at batch 2 and at the served batch of
# 128, a single pixel (M = 1), and C_in, C_out not multiples of 16 (the
# mma_sync route, 4-byte copies) with a ragged M; each at scales with an
# exact_inv_out_scale proof, joined by the reciprocal and by the divide,
# and at a triple with none (1.6447..., 0.6804..., 1.3818...), by the
# divide only.
NO_PROOF = (1.644742727279663, 0.680426299571991, 1.3817954063415527)


def _expand_case(cuda, N, C, O, H, seed):
    rng = np.random.default_rng(seed)
    cl = torch.channels_last
    x = _t(_i8(rng, (N, C, H, H)), cuda).contiguous(memory_format=cl)
    w = ops.pack_weight(_i8(rng, (O, C)), C, 1, cuda)   # [O, C, 1, 1]
    bias = _t(rng.integers(-3000, 3000, O).astype(np.int32), cuda)
    # acc has std ~ 74 * 74 * sqrt(C); scale it to std ~ 60
    f = _t((rng.uniform(0.5, 1.5, O) * 0.011 / np.sqrt(C)).astype(
        np.float32), cuda)
    r = _t(_i8(rng, (N, O, H, H)), cuda).contiguous(memory_format=cl)
    return x, w, bias, f, r


def _expand_once(args, inv, variant):
    """One K7 launch on ``variant``: its output, equal to the plain
    version's with the same ``inv_out``."""
    before = _kernels.launch_counts()["expand_add"]
    variants = dict(_kernels.KERNELS["expand_add"].variants)
    got = ops.expand_add_int8(*args, inv_out=inv)
    torch.cuda.synchronize()
    assert _kernels.launch_counts()["expand_add"] == before + 1
    _variant_launched("expand_add", variants, variant)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, ops.expand_add_int8_plain(*args, inv_out=inv))
    return got


@pytest.mark.parametrize("N,C,O,H,scales", [
    (2, 64, 256, 56, (0.0213, 0.0172, 0.0311)),
    (2, 128, 512, 28, (0.0213, 0.0172, 0.0311)),
    (2, 256, 1024, 14, (0.0213, 0.0172, 0.0311)),
    (2, 512, 2048, 7, (0.0213, 0.0172, 0.0311)),
    (1, 64, 256, 1, (0.0213, 0.0172, 0.0311)),
    (3, 12, 20, 5, (0.0213, 0.0172, 0.0311)),
    (128, 64, 256, 56, (0.0213, 0.0172, 0.0311)),
    (128, 128, 512, 28, (0.05, 0.061, 0.043)),
    (128, 256, 1024, 14, (0.05, 0.06, 0.07)),
    (128, 512, 2048, 7, (0.0213, 0.0172, 0.0311)),
    (2, 64, 256, 56, NO_PROOF), (3, 12, 20, 5, NO_PROOF),
    (128, 256, 1024, 14, NO_PROOF)])
def test_expand_add(cuda, N, C, O, H, scales):
    x, w, bias, f, r = _expand_case(cuda, N, C, O, H, C + O + H)
    args = (x, w.reshape(O, C), bias, f, r, *scales)
    plan = ops.expand_plan(x, w.reshape(O, C), bias, f, r)
    assert plan.variant == ("wgmma_tma" if C % 16 == 0 else "mma_sync")
    inv = ops.exact_inv_out_scale(*scales)
    assert (inv is None) == (scales == NO_PROOF)
    got = _expand_once(args, None, plan.variant)
    if inv is not None:
        assert torch.equal(_expand_once(args, inv, plan.variant), got)
    # K2 at kernel 1 with its fused join computes the same function
    assert torch.equal(got, ops.conv2d_int8(x, w, bias, f, residual=r,
                                            res_scales=scales))
    if N * H * H > 1:
        assert int(got.max()) - int(got.min()) > 100


@pytest.mark.parametrize("inv", [False, True])
def test_expand_add_residual_off_16_bytes(cuda, inv):
    """ResNet-50's stage-1 c3 at batch 2 with the residual 4 bytes off a
    16-byte boundary: TMA does not take it, so K7 runs mma_sync, and gives
    the bits of the plain version and of wgmma_tma on an aligned copy."""
    N, C, O, H = 2, 64, 256, 56
    scales = (0.0213, 0.0172, 0.0311)
    x, w, bias, f, r = _expand_case(cuda, N, C, O, H, 7)
    cl = torch.channels_last
    flat = torch.empty(r.numel() + 4, dtype=torch.int8, device=cuda)
    off = flat[4:].view(N, H, H, O).permute(0, 3, 1, 2)
    off.copy_(r)
    assert off.is_contiguous(memory_format=cl) and off.data_ptr() % 16 == 4
    s_inv = ops.exact_inv_out_scale(*scales) if inv else None
    w2 = w.reshape(O, C)
    assert ops.expand_plan(x, w2, bias, f, off).variant == "mma_sync"
    got = _expand_once((x, w2, bias, f, off, *scales), s_inv, "mma_sync")
    want = _expand_once((x, w2, bias, f, r, *scales), s_inv, "wgmma_tma")
    assert torch.equal(got, want)


def test_expand_add_saturated(cuda):
    """Every input and weight -128 at C_in = 512 (ResNet-50's stage-4 c3):
    acc = 2^23 + bias, with biases that carry it past 2^24, where float(acc)
    rounds."""
    rng = np.random.default_rng(12)
    N, C, O, H, cl = 2, 512, 2048, 7, torch.channels_last
    x = torch.full((N, C, H, H), -128, dtype=torch.int8,
                   device=cuda).contiguous(memory_format=cl)
    w = torch.full((O, C), -128, dtype=torch.int8, device=cuda)
    bias = _t(rng.integers(-2**24, 2**24, O).astype(np.int32), cuda)
    f = _t((rng.uniform(0.5, 1.5, O) * 100 / 2**24).astype(np.float32),
           cuda)
    r = _t(_i8(rng, (N, O, H, H)), cuda).contiguous(memory_format=cl)
    args = (x, w, bias, f, r, 0.0213, 0.0172, 0.0311)
    got = ops.expand_add_int8(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, ops.expand_add_int8_plain(*args))


def test_expand_add_refuses_nchw_residual(cuda):
    x = torch.zeros(1, 8, 3, 3, dtype=torch.int8, device=cuda).contiguous(
        memory_format=torch.channels_last)
    w = torch.zeros(16, 8, dtype=torch.int8, device=cuda)
    v = torch.zeros(16, dtype=torch.int32, device=cuda)
    r = torch.zeros(1, 16, 3, 3, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="channels_last"):
        ops.expand_add_int8(x, w, v, v.float(), r, 1.0, 1.0, 1.0)


# K5 against its plain version (TF32 off) at rtol = atol = 2e-5, the
# tolerance the JAX kernel is held to: float32 sums in another order.  The
# LM's prefill runs BH = 8 (one request) and 64 (eight), T = 640, dh = 64,
# causal; T = 1, 63 and 1000 take the ragged edges.
@pytest.mark.parametrize("dh", [16, 64, 128])
@pytest.mark.parametrize("T", [1, 63, 640, 1000])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("BH", [1, 8, 24, 64])
def test_flash_attention(cuda, dh, T, causal, BH):
    gen = torch.Generator(device=cuda).manual_seed(dh + T + BH)
    q, k, v = (torch.randn((BH, T, dh), generator=gen, device=cuda)
               for _ in range(3))
    before = _kernels.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert _kernels.launch_counts()["flash_attention"] == before + 1
    want = ops.flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    assert torch.isfinite(got).all()
    # each head's rows, run alone, are the same bits (the chunk plan does
    # not depend on BH)
    for h in range(BH):
        alone = ops.flash_attention(q[h:h + 1], k[h:h + 1], v[h:h + 1],
                                    causal=causal)
        assert torch.equal(alone[0], got[h]), h


def test_flash_attention_refuses_wide_heads(cuda):
    q = torch.zeros((2, 8, 160), device=cuda)
    with pytest.raises(ValueError, match="dh <= 128"):
        ops.flash_attention(q, q, q)


# The K2′ and K9 shapes (tests/test_conv_bm.py, tests/test_conv_pm.py):
# K2 computes those kernels' function; tests/test_torch_conv_routes.py
# holds them against K2's plain version on the CPU.
@pytest.mark.parametrize("C,H,W,join", [
    (64, 8, 8, False), (64, 8, 8, True), (8, 6, 5, False), (16, 4, 3, False),
    (8, 5, 4, True), (8, 4, 3, True)])
def test_conv_route_shapes(cuda, C, H, W, join):
    rng = np.random.default_rng(C + H + W)
    cl = torch.channels_last
    x = _t(_i8(rng, (128, C, H, W)), cuda).contiguous(memory_format=cl)
    w = ops.pack_weight(_i8(rng, (C, C * 9)), C, 3, cuda)
    bias = _t(rng.integers(-8000, 8000, C).astype(np.int32), cuda)
    f = _t((rng.uniform(0.5, 1.5, C) * 0.011 / np.sqrt(C * 9)).astype(
        np.float32), cuda)
    kw = dict(padding=1, relu=not join)
    if join:
        r = _t(_i8(rng, (128, C, H, W)), cuda).contiguous(memory_format=cl)
        kw.update(residual=r, res_scales=(0.043719, 0.029153, 0.061347))
    got = ops.conv2d_int8(x, w, bias, f, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, ops.conv2d_int8_plain(x, w, bias, f, **kw))


def _sconv_case(cuda, N, C, O, H, k, stride, block_o, block_c, sparsity,
                seed):
    from resnet_accel_tpu_torch.sparse import (device_pack, pack_conv_bsr,
                                               tap_sparse_weight)
    rng = np.random.default_rng(seed)
    w = tap_sparse_weight(rng, O, C, k, sparsity, block_o, block_c)
    x = _t(_i8(rng, (N, C, H, H)), cuda).contiguous(
        memory_format=torch.channels_last)
    packed = device_pack(pack_conv_bsr(w, padding=k // 2, block_o=block_o,
                                       block_c=block_c), cuda)
    bias = _t(rng.integers(-3000, 3000, O).astype(np.int32), cuda)
    # acc has std ~ 74 * 74 * sqrt(C*k*k * (1 - sparsity)); scale to ~ 60
    f = _t((rng.uniform(0.5, 1.5, O) * 0.011 / np.sqrt(
        C * k * k * max(1 - sparsity, 0.1))).astype(np.float32), cuda)
    return w, x, packed, bias, f


def _sconv_once(x, packed, variant, **kw):
    """One K8 call: one launch, on route ``variant`` (its plan's)."""
    assert ops.sparse_conv_plan(x, packed).variant == variant
    before = _kernels.launch_counts()["sparse_conv"]
    routes = dict(_kernels.variant_counts().get("sparse_conv", {}))
    got = ops.sparse_conv2d_int8(x, packed, **kw)
    torch.cuda.synchronize()
    assert _kernels.launch_counts()["sparse_conv"] == before + 1
    routes[variant] = routes.get(variant, 0) + 1
    assert _kernels.variant_counts()["sparse_conv"] == routes
    assert got.is_contiguous(memory_format=torch.channels_last)
    return got


def _sconv_dense(x, w, bias, f, stride, k, cuda):
    """The dense K2 on the same weights, ReLU and requant."""
    O, C = w.shape[:2]
    wd = ops.pack_weight(w.reshape(O, -1), C, k, cuda)
    return ops.conv2d_int8(x, wd, bias, f, stride=stride, padding=k // 2,
                           relu=True)


# tests/test_sparse_conv.py's shapes (3x3 stride 1 and 2, the 1x1/s2
# downsample at block_c 64 -- here with two output blocks, one of them
# empty --, 64-wide blocks, O = 100 at block_o 104) and the conv sweep's
# l3.c1 at batch 64 (one of its two output blocks empty too): all on the
# Hopper route.
@pytest.mark.parametrize("N,C,O,H,k,stride,block_o,block_c,sparsity", [
    (2, 128, 128, 10, 3, 1, 128, 128, 0.5), (2, 128, 128, 9, 3, 2, 128, 128,
                                             0.4),
    (2, 64, 256, 8, 1, 2, 128, 64, 0.5), (1, 64, 64, 9, 3, 2, 64, 64, 0.4),
    (3, 128, 100, 6, 3, 1, 128, None, 0.0),
    (64, 128, 256, 28, 3, 2, 128, None, 0.7)])
@pytest.mark.parametrize("mode", ["int32", "int32+bias+relu", "requant"])
def test_sparse_conv(cuda, N, C, O, H, k, stride, block_o, block_c, sparsity,
                     mode):
    w, x, packed, bias, f = _sconv_case(cuda, N, C, O, H, k, stride,
                                        block_o, block_c, sparsity, C + O + H)
    kw = dict(stride=stride)
    if mode != "int32":
        kw.update(bias=bias, relu=True)
    if mode == "requant":
        kw.update(factors=f)
    got = _sconv_once(x, packed, "wgmma_tma", **kw)
    want = ops.sparse_conv2d_int8_plain(x, packed, **kw)
    assert got.dtype == want.dtype and torch.equal(got, want)
    if mode == "requant":
        # the dense K2 on the same weights gives the same bits
        assert torch.equal(got, _sconv_dense(x, w, bias, f, stride, k, cuda))
        assert int(want.max()) - int(want.min()) > 100


def test_sparse_conv_empty_output_block(cuda):
    """Output blocks with no stored block still write the epilogue: the
    bias through ReLU and requant, or zeros without a bias."""
    w, x, packed, bias, f = _sconv_case(cuda, 2, 128, 256, 6, 3, 1, 128,
                                        None, 0.0, 5)
    from resnet_accel_tpu_torch.sparse import device_pack, pack_conv_bsr
    w[128:] = 0
    packed = device_pack(pack_conv_bsr(w, padding=1), cuda)
    assert packed.o_ptr.tolist()[1] == packed.o_ptr.tolist()[2]
    got = _sconv_once(x, packed, "wgmma_tma", bias=bias, factors=f,
                      relu=True)
    assert torch.equal(got, ops.sparse_conv2d_int8_plain(
        x, packed, bias=bias, factors=f, relu=True))
    empty = ops.requantize(bias[128:].clamp_min(0), f[128:])
    assert torch.equal(got[:, 128:], empty.view(1, -1, 1, 1).expand(
        2, -1, 6, 6))
    zeros = _sconv_once(x, device_pack(pack_conv_bsr(
        np.zeros_like(w), padding=1), cuda), "wgmma_tma")
    assert zeros.dtype == torch.int32 and not zeros.any()


# The conv sweep's four cases (ResNet-18's strided convs at ImageNet
# widths, 128 x 128 blocks at 0.7) at batch 4, int8 and int32 out.
@pytest.mark.parametrize("case", CONV_CASES, ids=[c[0] for c in CONV_CASES])
@pytest.mark.parametrize("requant", [True, False])
def test_sparse_conv_sweep_shapes(cuda, case, requant):
    _, C, O, H, k, stride, _ = case
    w, x, packed, bias, f = _sconv_case(cuda, 4, C, O, H, k, stride, 128,
                                        None, 0.7, O + k)
    kw = dict(stride=stride, bias=bias, relu=True,
              factors=f if requant else None)
    got = _sconv_once(x, packed, "wgmma_tma", **kw)
    assert torch.equal(got, ops.sparse_conv2d_int8_plain(x, packed, **kw))
    if requant:
        assert torch.equal(got, _sconv_dense(x, w, bias, f, stride, k, cuda))


# The Hopper route's tiles (64 channels of one output block): block_c 32,
# 64 and 128 (K stages of 32, 64 and 128 bytes); block_o 32, 64, 96, 128
# and 256 (one to four tiles a block); partial last output blocks
# (c_out % block_o != 0: a tile short of 64 columns, a tile past c_out
# that stores nothing, int8 by TMA store or from the fragments); no
# stored block at all.
@pytest.mark.parametrize("N,C,O,H,k,stride,block_o,block_c,sparsity", [
    (2, 64, 128, 14, 3, 1, 128, 32, 0.5), (2, 128, 256, 14, 3, 2, 64, 64,
                                           0.5),
    (2, 256, 512, 7, 3, 1, 256, 128, 0.5), (3, 64, 100, 9, 3, 2, 32, 32,
                                            0.4),
    (2, 128, 200, 8, 3, 1, 128, 64, 0.3), (2, 64, 144, 8, 3, 1, 128, 32,
                                           0.3),
    (2, 64, 192, 8, 3, 2, 96, 32, 0.4), (2, 64, 96, 8, 1, 2, 64, 32, 0.5),
    (2, 128, 256, 9, 3, 2, 128, None, 1.0), (1, 64, 64, 5, 1, 1, 64, 64,
                                             1.0)])
@pytest.mark.parametrize("requant", [True, False])
def test_sparse_conv_hopper_tiles(cuda, N, C, O, H, k, stride, block_o,
                                  block_c, sparsity, requant):
    w, x, packed, bias, f = _sconv_case(cuda, N, C, O, H, k, stride,
                                        block_o, block_c, sparsity,
                                        C + O + H + k)
    if sparsity == 1.0:
        assert packed.nnz_source == 0
    kw = dict(stride=stride, bias=bias, relu=True,
              factors=f if requant else None)
    got = _sconv_once(x, packed, "wgmma_tma", **kw)
    assert torch.equal(got, ops.sparse_conv2d_int8_plain(x, packed, **kw))
    if requant:
        assert torch.equal(got, _sconv_dense(x, w, bias, f, stride, k, cuda))


@pytest.mark.parametrize("offset", [8, 4])
def test_sparse_conv_x_off_16_bytes(cuda, offset):
    """The conv sweep's l3.c1 at batch 2 with x ``offset`` bytes off a
    16-byte boundary: TMA does not take it, so K8 runs mma_sync (byte
    loads of x), and gives the bits of the plain version, of the dense K2
    and of wgmma_tma on an aligned copy."""
    N, C, O, H, k, stride = 2, 128, 256, 28, 3, 2
    w, x, packed, bias, f = _sconv_case(cuda, N, C, O, H, k, stride, 128,
                                        None, 0.7, 11)
    flat = torch.empty(x.numel() + offset, dtype=torch.int8, device=cuda)
    off = flat[offset:].view(N, H, H, C).permute(0, 3, 1, 2)
    off.copy_(x)
    assert off.is_contiguous(memory_format=torch.channels_last)
    assert off.data_ptr() % 16 == offset
    kw = dict(stride=stride, bias=bias, factors=f, relu=True)
    got = _sconv_once(off, packed, "mma_sync", **kw)
    assert torch.equal(got, ops.sparse_conv2d_int8_plain(x, packed, **kw))
    assert torch.equal(got, _sconv_once(x, packed, "wgmma_tma", **kw))
    assert torch.equal(got, _sconv_dense(x, w, bias, f, stride, k, cuda))


# Blocks the Hopper route does not take, on the mma_sync route: off the
# 32-channel step, (block_c, block_o) = (16, 14) at the conv sweep's l3.c1
# and l4.ds shapes at batch 2 (O not a multiple of 14, so the packer's
# padded channels must never be stored), and (8, 4); on it but with
# block_o % 8 != 0, (32, 12) and (64, 20) (whole 16-byte loads).
@pytest.mark.parametrize("N,C,O,H,k,stride,block_c,block_o", [
    (2, 128, 256, 28, 3, 2, 16, 14), (2, 256, 512, 14, 1, 2, 16, 14),
    (2, 24, 28, 9, 3, 1, 8, 4), (3, 16, 12, 7, 3, 2, 8, 4),
    (2, 64, 36, 9, 3, 2, 32, 12), (2, 128, 40, 8, 3, 1, 64, 20)])
def test_sparse_conv_block_shapes(cuda, N, C, O, H, k, stride, block_c,
                                  block_o):
    w, x, packed, bias, f = _sconv_case(cuda, N, C, O, H, k, stride,
                                        block_o, block_c, 0.6, C + O + H)
    kw = dict(stride=stride, bias=bias, factors=f, relu=True)
    got = _sconv_once(x, packed, "mma_sync", **kw)
    assert torch.equal(got, ops.sparse_conv2d_int8_plain(x, packed, **kw))
    assert torch.equal(got, _sconv_dense(x, w, bias, f, stride, k, cuda))
    raw = _sconv_once(x, packed, "mma_sync", stride=stride)
    assert torch.equal(raw, ops.sparse_conv2d_int8_plain(x, packed,
                                                          stride=stride))


def _stem_int8(q, w, bias, f, pool):
    """K10 on the OIHW weight and on its packed form, each one launch: both
    the plain version's bits; returns the output."""
    want = ops.stem_conv_pool_int8_plain(q, w, bias, f, pool)
    for weight in (w, ops.pack_stem_weight(w)):
        before = _kernels.launch_counts()["stem_int8"]
        got = ops.stem_conv_pool_int8(q, weight, bias, f, pool=pool)
        torch.cuda.synchronize()
        assert _kernels.launch_counts()["stem_int8"] == before + 1
        assert got.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(got, want)
    return got


# K10 at ResNet-18's stem (224), at a size whose pooled output (58) and
# conv output (116) are not multiples of the tiles, at ragged and odd sizes
# (odd W takes the byte loads, even W the 16-bit ones) and at a batch of
# 12 at 224 x 224 (every persistent CTA walks more than two tiles); pooled,
# it equals K1 on the fp32 images the int8 ones came from.
@pytest.mark.parametrize("N,H,W", [(2, 224, 224), (2, 232, 232),
                                   (1, 37, 50), (1, 28, 16), (1, 31, 29),
                                   (12, 224, 224)])
@pytest.mark.parametrize("pool", [True, False])
def test_stem_int8(cuda, N, H, W, pool):
    rng = np.random.default_rng(H + W)
    x = _t(rng.normal(0, 1, (N, 3, H, W)).astype(np.float32), cuda)
    w = _t(_i8(rng, (64, 3, 7, 7)), cuda)
    bias = _t(rng.integers(-5000, 5000, 64).astype(np.int32), cuda)
    f = _t(rng.uniform(0.001, 0.01, 64).astype(np.float32), cuda)
    scale = float(x.abs().max().item() / 127.0)
    q = ops.quantize_input(x, scale)
    if N == 12:
        tiles, ctas = ops.stem_plan(N, H, W, _kernels.sm_count(cuda), pool)
        assert tiles > 2 * ctas
    got = _stem_int8(q, w, bias, f, pool)
    if pool:
        assert torch.equal(got, ops.stem_conv_pool(x, w, bias, f, scale))


@pytest.mark.parametrize("N,H,W", [(2, 64, 48), (1, 31, 29)])
@pytest.mark.parametrize("pool", [True, False])
def test_stem_int8_saturated(cuda, N, H, W, pool):
    """Inputs of -128 and 127 against weights of -128, 127 and -127: the
    largest sums the int8 GEMM can form."""
    rng = np.random.default_rng(W + pool)
    q = _t(rng.choice(np.int8([-128, 127, 0]), (N, 3, H, W)), cuda)
    w = _t(rng.choice(np.int8([-128, 127, -127]), (64, 3, 7, 7)), cuda)
    bias = _t(rng.integers(-5000, 5000, 64).astype(np.int32), cuda)
    # |acc| <= 147 * 128 * 128: factors that keep the requant in range
    f = _t(rng.uniform(2e-5, 6e-5, 64).astype(np.float32), cuda)
    _stem_int8(q, w, bias, f, pool)


@pytest.mark.parametrize("pool", [True, False])
def test_stem_int8_odd_address(cuda, pool):
    """Images at an odd address (a view one byte into a buffer): even W,
    but the 16-bit row loads would be misaligned, so the bytes path."""
    rng = np.random.default_rng(7)
    N, H, W = 2, 40, 36
    buf = _t(_i8(rng, (N * 3 * H * W + 1,)), cuda)
    q = buf[1:].view(N, 3, H, W)
    assert q.data_ptr() % 2 == 1
    w = _t(_i8(rng, (64, 3, 7, 7)), cuda)
    bias = _t(rng.integers(-5000, 5000, 64).astype(np.int32), cuda)
    f = _t(rng.uniform(0.001, 0.01, 64).astype(np.float32), cuda)
    _stem_int8(q, w, bias, f, pool)


def test_int8_forward(cuda):
    """The int8-input forward (K10 on the packed weight, never K1) gives
    the logits of the fp32-input forward of the images it came from and of
    the plain path."""
    from resnet_accel_tpu_torch.models.resnet18 import (
        ResNet18Int8Module, init_resnet18_fp32, quantize_resnet18)
    stages = [(64, 1, 1), (128, 1, 2)]
    rng = np.random.default_rng(2)
    params = init_resnet18_fp32(seed=0, num_classes=10, stages=stages)
    model = quantize_resnet18(params, rng.normal(0, 1, (2, 3, 64, 64)).astype(
        np.float32), 10, stages=stages)
    mod = ResNet18Int8Module(model, cuda)
    x = _t(rng.normal(0, 1, (4, 3, 64, 64)).astype(np.float32), cuda)
    q = ops.quantize_input(x, mod.s_input)
    before = _kernels.launch_counts()
    with torch.inference_mode():
        got = mod(q)
        torch.cuda.synchronize()
        after = _kernels.launch_counts()
        assert after["stem_int8"] == before["stem_int8"] + 1
        assert after["stem_fused"] == before["stem_fused"]
        assert torch.equal(got, mod(x))
        assert torch.equal(got, mod.forward_plain(q))


# K6 at the stem's shape, at a ragged one, and at C = 4; odd batches.
@pytest.mark.parametrize("N,C,H,W", [
    (1, 3, 224, 224), (3, 3, 224, 224), (128, 3, 224, 224), (1, 3, 34, 50),
    (3, 3, 34, 50), (128, 3, 34, 50), (1, 4, 224, 224), (3, 4, 34, 50),
    (128, 4, 34, 50)])
def test_stem_pack(cuda, N, C, H, W):
    rng = np.random.default_rng(N + H + C)
    x = _t(rng.normal(0, 1, (N, C, H, W)).astype(np.float32), cuda)
    scale = float(x.abs().max().item() / 127.0)
    before = _kernels.launch_counts()["stem_pack"]
    got = ops.quantize_s2d(x, scale)
    torch.cuda.synchronize()
    assert _kernels.launch_counts()["stem_pack"] == before + 1
    assert got.shape == (N, 4 * C, H // 2, W // 2)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, ops.quantize_s2d_nchw(x, scale))


def test_stem_pack_ties_and_saturation(cuda):
    """Exact rounding ties (k + 0.5) * s go to the even neighbour, and
    values past the int8 range saturate: a reciprocal multiply or roundf
    would move some of them."""
    s = 0.0173
    k = np.arange(-140, 140, dtype=np.float32)
    vals = np.concatenate([(k + 0.5) * np.float32(s), k * np.float32(s),
                           np.float32([1e6, -1e6, 0.0, -0.0])])
    x = np.resize(vals, (3, 3, 20, 12)).astype(np.float32)
    got = ops.quantize_s2d(_t(x, cuda), s)
    torch.cuda.synchronize()
    want = np.clip(np.rint(x / np.float32(s)), -128, 127).astype(np.int8)
    want = want.reshape(3, 3, 10, 2, 6, 2).transpose(0, 1, 3, 5, 2, 4)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  want.reshape(3, 12, 10, 6))


def test_stem_pack_refuses_odd(cuda):
    with pytest.raises(ValueError, match="even"):
        ops.quantize_s2d(torch.zeros((1, 3, 5, 4), device=cuda), 0.1)


# K2 with per-side padding: the space-to-depth stem's 4x4 conv at C = 12
# (the 112 x 112 output of the 224 image, and a ragged one), and a 3x3 with
# every side different.
@pytest.mark.parametrize("N,C,O,H,W,k,pad", [
    (2, 12, 64, 112, 112, 4, ((2, 1), (2, 1))),
    (3, 12, 64, 17, 25, 4, ((2, 1), (2, 1))),
    (2, 8, 12, 9, 11, 3, ((0, 2), (1, 0)))])
def test_conv_per_side_padding(cuda, N, C, O, H, W, k, pad):
    rng = np.random.default_rng(C + H + W)
    x = _t(_i8(rng, (N, C, H, W)), cuda).contiguous(
        memory_format=torch.channels_last)
    w = ops.pack_weight(_i8(rng, (O, C * k * k)), C, k, cuda)
    bias = _t(rng.integers(-3000, 3000, O).astype(np.int32), cuda)
    f = _t((rng.uniform(0.5, 1.5, O) * 0.011 / np.sqrt(C * k * k)).astype(
        np.float32), cuda)
    kw = dict(padding=pad, relu=True)
    before = dict(_kernels.KERNELS["conv_int8"].variants)
    got = ops.conv2d_int8(x, w, bias, f, **kw)
    torch.cuda.synchronize()
    _variant_launched("conv_int8", before, "mma_sync")
    want = ops.conv2d_int8_plain(x, w, bias, f, **kw)
    (t, b), (l, r) = pad
    assert want.shape[2:] == (H + t + b - k + 1, W + l + r - k + 1)
    assert torch.equal(got, want)


def test_s2d_stem_equals_k1(cuda):
    """K6, then K2's 4x4 conv on the regrouped weights, then the pool: the
    bits of K1 on the same images."""
    rng = np.random.default_rng(9)
    x = _t(rng.normal(0, 1, (3, 3, 64, 48)).astype(np.float32), cuda)
    w7 = _i8(rng, (64, 3 * 49))
    bias = _t(rng.integers(-5000, 5000, 64).astype(np.int32), cuda)
    f = _t(rng.uniform(0.001, 0.01, 64).astype(np.float32), cuda)
    scale = float(x.abs().max().item() / 127.0)
    w4 = ops.pack_weight(ops.stem_s2d_weights(w7, 3, 7), 12, 4, cuda)
    a = ops.conv2d_int8(ops.quantize_s2d(x, scale), w4, bias, f,
                        padding=((2, 1), (2, 1)), relu=True)
    got = ops.maxpool2d_int8(a, 3, 2, padding=1)
    torch.cuda.synchronize()
    k1 = ops.stem_conv_pool(x, _t(w7.reshape(64, 3, 7, 7), cuda), bias, f,
                            scale)
    assert torch.equal(got, k1)


def test_probes(cuda):
    """The probe kernels against their plain versions; the stem tile with
    no stage knocked out is K1, on either weight."""
    from resnet_accel_tpu_torch import probes
    rng = np.random.default_rng(3)
    for M, K in ((64, 192), (128, 576)):
        a = _t(rng.integers(-4, 4, (M, K)).astype(np.int8), cuda)
        b = _t(rng.integers(-4, 4, (64, K)).astype(np.int8), cuda)
        got = probes.mma_s8(a, b, 5, 3)
        assert torch.equal(got, probes.mma_s8_plain(a, b, 5, 3))
    x = _t(rng.integers(-100, 100, (512, 4)).astype(np.int32), cuda)
    for kind in probes.CHAIN_KINDS:
        assert torch.equal(probes.chain(x, 17, kind),
                           probes.chain_plain(x, 17, kind))
    xs = _t(rng.normal(0, 1, (2, 3, 64, 64)).astype(np.float32), cuda)
    w = _t(_i8(rng, (64, 3, 7, 7)), cuda)
    bias = _t(rng.integers(-5000, 5000, 64).astype(np.int32), cuda)
    f = _t(rng.uniform(0.001, 0.01, 64).astype(np.float32), cuda)
    before = _kernels.launch_counts()
    for mode in probes.STEM_MODES:
        out = probes.stem_ablation(xs, w, bias, f, 0.02, mode)
        if mode == "full":
            k1 = ops.stem_conv_pool(xs, w, bias, f, 0.02)
            assert torch.equal(out, k1)
            assert torch.equal(probes.stem_ablation(
                xs, ops.pack_stem_weight(w), bias, f, 0.02, mode), k1)
    torch.cuda.synchronize()
    before["stem_fused"] += 1
    assert _kernels.launch_counts() == before



def _fc1_artifact(cuda):
    """``bench --artifact``'s K4 operand at the reference's FC1 geometry:
    a seeded int8 [128, 9216] with 14 x 14 blocks zeroed at 0.9, exported
    at 14 x 14 and regrouped to 128 x 128 (every superblock stored)."""
    from resnet_accel_tpu_torch.sparse import (build_bsr_int8_direct,
                                               regroup_bsr)
    rng = np.random.default_rng(9216)
    w = _i8(rng, (128, 9216))
    keep = rng.random((10, 659)) >= 0.9
    w *= np.repeat(np.repeat(keep, 14, 0), 14, 1)[:128, :9216].astype(
        np.int8)
    return ops.pack_bsr(regroup_bsr(build_bsr_int8_direct(w, 14)), cuda)


def _artifact_act(M, cuda):
    """``bench --artifact``'s activation: ((k + m) % 256) - 128."""
    return _t(((np.arange(9216)[None, :] + np.arange(M)[:, None]) % 256
               - 128).astype(np.int8), cuda)


# K4 on the regrouped FC1 at batch 1 (127 of the M tile's 128 rows padding)
# and 128, on its Hopper path.
@pytest.mark.parametrize("M", [1, 128])
def test_bsr_matmul_artifact(cuda, M):
    pk = _fc1_artifact(cuda)
    a = _artifact_act(M, cuda)
    before = dict(_kernels.KERNELS["bsr_matmul"].variants)
    got = ops.bsr_matmul_wt(a, pk)
    torch.cuda.synchronize()
    _variant_launched("bsr_matmul", before, "wgmma_tma")
    assert torch.equal(got, ops.bsr_matmul_wt_plain(a, pk))


def test_bsr_matmul_artifact_graph_chain(cuda):
    """``bench --artifact``'s timed chain: K4 and its feedback captured in
    a CUDA graph (4 calls), replayed twice after one eager call, equal to
    nine dependent calls of the plain version; the captures counted once
    and the replays not at all."""
    from resnet_accel_tpu_torch.cli import Chain, artifact_step
    pk = _fc1_artifact(cuda)
    a = _artifact_act(1, cuda)
    want = a.clone()
    step = artifact_step(pk, 128)
    before = _kernels.launch_counts()["bsr_matmul"]
    step(a)
    chain = Chain(step, a, 4)
    chain()
    chain()
    torch.cuda.synchronize()
    assert chain.runs == 2
    assert _kernels.launch_counts()["bsr_matmul"] == before + 1 + 4
    for _ in range(9):
        out = ops.bsr_matmul_wt_plain(want, pk)
        want[:, :128] += (out[:, :128] & 1).to(torch.int8)
    assert not torch.equal(want, _artifact_act(1, cuda))
    assert torch.equal(a, want)
