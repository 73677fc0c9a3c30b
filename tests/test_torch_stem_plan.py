"""PyTorch port: the stem tile's walk (K1's and K10's), on the CPU.

K1 (``csrc/stem_fused.cu``) and K10 (``csrc/stem_int8.cu``) run the
stem's 7x7/s2/p3 conv as an int8 GEMM over a space-to-depth window in
shared memory (``csrc/stem_mma_tile.cuh``): a pooled tile is one image's
7 x 8 pooled outputs over the 15 x 17 conv outputs under them (M = 255,
padded to 256 rows), an unpooled one (K10's) 16 x 16 conv outputs (M =
256); the window holds the int8 input as [row pair][column pair][12
bytes], the pairs counted from the window's own origin ``2 * ch0 - 4``;
A's word w of row m is read at ``base(m) + off(w)`` words; B is
:func:`pack_stem_weight`'s [64, 192].  The model below is that walk in
PyTorch, and the tests hold it to the plain version: its accumulators to
the int32 sums of ``im2col_nchw`` and the exact GEMM (the sums inside
``conv2d_int8_plain``), and its conv tile pushed through the pool and
the requant to ``stem_conv_pool_plain`` (unpooled: the requant of every
output to ``stem_conv_pool_int8_plain(..., pool=False)``), at geometries
with both window-origin parities, odd sizes and M's pad row, and once
each to the JAX package's ``stem_conv_pool_nm`` and ``fused_stem_pool(...,
pool=False)``.  K10's staging (16-bit row loads where W is even, bytes
otherwise) is modelled on the flat int8 images and held to the words of
the quantized fp32 ones.  Exact: integer sums and indexing.  The kernels
themselves are held to the plain versions on the card (``test_stem`` and
``test_stem_int8`` in tests/test_torch_kernels.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from resnet_accel_tpu.ops.conv import stem_s2d_weights as j_stem_s2d_weights
from resnet_accel_tpu.ops.fused_stem import fused_stem_pool as j_fused_stem
from resnet_accel_tpu.ops.stem_fused import stem_conv_pool_nm
from resnet_accel_tpu_torch import ops
from resnet_accel_tpu_torch.ops.conv import im2col_nchw, stem_s2d_weights
from resnet_accel_tpu_torch.ops.epilogue import quantize_input, requantize
from resnet_accel_tpu_torch.ops.matmul_int8 import matmul_int8_plain
from resnet_accel_tpu_torch.ops.stem_fused import (
    STEM_CONV_TILE, STEM_CTAS_PER_SM, STEM_K, STEM_OUT, STEM_TILE,
    pack_stem_weight, stem_conv_hw, stem_out_hw, stem_plan,
    unpack_stem_weight)

torch.set_num_threads(2)

TH, TW = STEM_TILE
CH, CW = 2 * TH + 1, 2 * TW + 1        # conv rows, cols under a tile
M = CH * CW                            # the GEMM's rows
M_PAD = -(-M // 16) * 16               # in m16 tiles
ROW_PAIRS, COL_PAIRS = CH + 3, CW + 3  # of the s2d window


def row_pitch(col_pairs: int = COL_PAIRS, cw: int = CW) -> int:
    """The kernel's ``kPitch``: words a row pair, at least 3 a column pair,
    = 3 * cw + 1 mod 32 where an m16 tile may cross a conv row's end (cw
    not a multiple of 16)."""
    p = 3 * col_pairs
    if cw % 16 == 0:
        return p
    while p % 32 != (3 * cw + 1) % 32:
        p += 1
    return p


PITCH = row_pitch()


def off(w: int) -> int:
    """Words from A row m's base to its K word w: tap w // 3 (kh2 = w //
    12, kw2 = w // 3 % 4), byte quad w % 3."""
    return (w // 12) * PITCH + w % 12


def base(m: int) -> int:
    """A row m's first word in the window: conv position (m // CW, m % CW),
    clamped into the tile (the pad row reads the last real row)."""
    m = min(m, M - 1)
    return (m // CW) * PITCH + (m % CW) * 3


def window(xq: torch.Tensor, ch0: int, cw0: int, row_pairs: int = ROW_PAIRS,
           col_pairs: int = COL_PAIRS, pitch: int = PITCH) -> torch.Tensor:
    """The staged window of the tile whose first conv output is (ch0,
    cw0): [N, row_pairs * pitch * 4] bytes, pair (i, j)'s 12 bytes (c, rp,
    cp) at word i * pitch + 3 j, input row 2 * ch0 - 4 + 2 i + rp, 0
    outside the image."""
    N, C, H, W = xq.shape
    ih0, iw0 = 2 * ch0 - 4, 2 * cw0 - 4
    canvas = torch.zeros((N, C, 2 * row_pairs, 2 * col_pairs),
                         dtype=torch.int8)
    h0, h1 = max(ih0, 0), min(ih0 + 2 * row_pairs, H)
    w0, w1 = max(iw0, 0), min(iw0 + 2 * col_pairs, W)
    if h0 < h1 and w0 < w1:
        canvas[:, :, h0 - ih0:h1 - ih0, w0 - iw0:w1 - iw0] = \
            xq[:, :, h0:h1, w0:w1]
    pairs = canvas.reshape(N, C, row_pairs, 2, col_pairs, 2).permute(
        0, 2, 4, 1, 3, 5)
    win = torch.zeros((N, row_pairs, pitch * 4), dtype=torch.int8)
    win[:, :, :col_pairs * 12] = pairs.reshape(N, row_pairs, col_pairs * 12)
    return win.reshape(N, -1)


def tile_window(xq: torch.Tensor, oh0: int, ow0: int) -> torch.Tensor:
    """The staged window of the pooled tile at pooled (oh0, ow0)."""
    return window(xq, 2 * oh0 - 1, 2 * ow0 - 1)


def a_index() -> torch.Tensor:
    """[M_PAD, 192] byte index of A's element (m, k) in the window: word
    base(m) + off(k // 4), byte k % 4."""
    return torch.tensor([[4 * (base(m) + off(k // 4)) + k % 4
                          for k in range(STEM_K)] for m in range(M_PAD)])


def tile_acc(xq: torch.Tensor, packed: torch.Tensor, oh0: int,
             ow0: int) -> torch.Tensor:
    """The tile's GEMM: A gathered from the window through off(), times the
    packed B -> int32 [N, M_PAD, 64]."""
    a = tile_window(xq, oh0, ow0)[:, a_index()]
    return (a.to(torch.int64) @ packed.to(torch.int64).t()).to(torch.int32)


def walk(x, packed, bias, factors, scale, check_acc=None):
    """K1's output by the model: every tile's GEMM, its conv tile (relu(acc
    + bias), -1 outside the conv output; the pad row never stored), the
    3x3/s2 max and one requant.  ``check_acc(acc, oh0, ow0)`` sees each
    tile's accumulators."""
    xq = quantize_input(x, scale)
    N, _, H, W = x.shape
    Hc, Wc = (H - 1) // 2 + 1, (W - 1) // 2 + 1
    Hp, Wp = stem_out_hw(H, W)
    out = torch.empty((N, STEM_OUT, Hp, Wp), dtype=torch.int8)
    for oh0 in range(0, Hp, TH):
        for ow0 in range(0, Wp, TW):
            acc = tile_acc(xq, packed, oh0, ow0)
            if check_acc is not None:
                check_acc(acc, oh0, ow0)
            ch = 2 * oh0 - 1 + torch.arange(M) // CW
            cw = 2 * ow0 - 1 + torch.arange(M) % CW
            valid = (ch >= 0) & (ch < Hc) & (cw >= 0) & (cw < Wc)
            conv = torch.where(valid[None, :, None],
                               (acc[:, :M] + bias).clamp_min(0),
                               torch.full_like(acc[:, :M], -1))
            conv = conv.reshape(N, CH, CW, STEM_OUT)
            pooled = torch.stack([conv[:, dr:dr + 2 * TH:2, dc:dc + 2 * TW:2]
                                  for dr in range(3) for dc in range(3)]
                                 ).amax(0)            # [N, TH, TW, 64]
            q = requantize(pooled, factors).permute(0, 3, 1, 2)
            h, w = min(TH, Hp - oh0), min(TW, Wp - ow0)
            out[:, :, oh0:oh0 + h, ow0:ow0 + w] = q[:, :, :h, :w]
    return out


def _case(N, H, W, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (N, 3, H, W)).astype(np.float32)
    w = rng.integers(-128, 128, (64, 3 * 49)).astype(np.int8)
    bias = rng.integers(-5000, 5000, 64).astype(np.int32)
    f = rng.uniform(0.001, 0.01, 64).astype(np.float32)
    return x, w, bias, f, float(np.abs(x).max() / 127.0)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# (1, 37, 50): the test_stem geometry, partial tiles both ways; (2, 16,
# 16): one tile an image; (1, 28, 16), (1, 31, 29): a conv output of even
# and odd size (14 x 8, 16 x 15), odd H and W, the last tile's rows and
# columns short or full.  The window's pairs start at its own origin row
# 4 oh0 - 6 (and column 4 ow0 - 6), so at odd H or W the last pair is half
# outside the image.
GEOMETRIES = [(1, 37, 50), (2, 16, 16), (1, 28, 16), (1, 31, 29)]


@pytest.mark.parametrize("N,H,W", GEOMETRIES)
def test_walk_equals_plain(N, H, W):
    x, w2d, bias, f, scale = _case(N, H, W, seed=H * W)
    w = _t(w2d.reshape(64, 3, 7, 7))
    packed = pack_stem_weight(w)
    xq = quantize_input(_t(x), scale)
    Hc, Wc = (H - 1) // 2 + 1, (W - 1) // 2 + 1
    # the int32 sums conv2d_int8_plain forms: im2col, then the exact GEMM
    want_acc = matmul_int8_plain(
        im2col_nchw(xq, 7, 2, 3).reshape(N * Hc * Wc, -1),
        w.reshape(64, -1).t()).reshape(N, Hc, Wc, 64)
    seen = []

    def check_acc(acc, oh0, ow0):
        for m in range(M):
            ch, cw = 2 * oh0 - 1 + m // CW, 2 * ow0 - 1 + m % CW
            if 0 <= ch < Hc and 0 <= cw < Wc:
                assert torch.equal(acc[:, m], want_acc[:, ch, cw]), (m, oh0)
                seen.append((ch, cw))

    got = walk(_t(x), packed, _t(bias), _t(f), scale, check_acc)
    # the tiles reach every conv output
    assert set(seen) == {(ch, cw) for ch in range(Hc) for cw in range(Wc)}
    want = ops.stem_conv_pool_plain(_t(x), w, _t(bias), _t(f), scale)
    assert got.shape == want.shape
    assert torch.equal(got, want)


def test_walk_equals_jax_fused_stem():
    """The model against the JAX fused stem at its own test geometry
    (batch 128, 16 x 16; interpret mode runs its reference
    composition)."""
    x, w2d, bias, f, scale = _case(128, 16, 16, seed=5)
    want = np.asarray(stem_conv_pool_nm(
        jnp.asarray(x), j_stem_s2d_weights(jnp.asarray(w2d), 3, 7),
        jnp.asarray(bias), jnp.asarray(f), scale, interpret=True))
    got = walk(_t(x), pack_stem_weight(_t(w2d.reshape(64, 3, 7, 7))),
               _t(bias), _t(f), scale)
    np.testing.assert_array_equal(got.numpy(), want)


def test_packed_weight_is_the_s2d_weight():
    """B, unpacked from the kernel's K order (tap, then s2d channel) to
    ``stem_s2d_weights``' (s2d channel, then tap), is that function's
    form of the weight; unpack_stem_weight inverts the packing."""
    w2d = np.random.default_rng(4).integers(-128, 128, (64, 147)).astype(
        np.int8)
    w = _t(w2d.reshape(64, 3, 7, 7))
    packed = pack_stem_weight(w)
    assert packed.shape == (64, STEM_K) and packed.dtype == torch.int8
    assert packed.is_contiguous()
    s2d = packed.reshape(64, 4, 4, 3, 2, 2).permute(0, 3, 4, 5, 1, 2)
    np.testing.assert_array_equal(s2d.reshape(64, STEM_K).numpy(),
                                  stem_s2d_weights(w2d, 3, 7))
    assert torch.equal(unpack_stem_weight(packed), w)


def test_plain_takes_either_weight():
    """K1's and K10's functions give the same bits on the packed weight
    as on the OIHW one (on the CPU, their plain versions)."""
    x, w2d, bias, f, scale = _case(2, 20, 23, seed=11)
    w = _t(w2d.reshape(64, 3, 7, 7))
    args = (_t(bias), _t(f), scale)
    assert torch.equal(ops.stem_conv_pool(_t(x), pack_stem_weight(w), *args),
                       ops.stem_conv_pool_plain(_t(x), w, *args))
    q = quantize_input(_t(x), scale)
    for pool in (True, False):
        assert torch.equal(
            ops.stem_conv_pool_int8(q, pack_stem_weight(w), *args[:2],
                                    pool=pool),
            ops.stem_conv_pool_int8_plain(q, w, *args[:2], pool=pool))


def test_a_loads_free_of_bank_conflicts():
    """Each of a warp's A loads (lanes g = lane / 4, t = lane % 4; rows g
    or g + 8 of an m16 tile, word 8 s + t or 8 s + t + 4) touches 32
    banks at most once each, or one word from several lanes."""
    for m0 in range(0, M_PAD, 16):
        for s in range(6):
            for dm, dw in ((0, 0), (8, 0), (0, 4), (8, 4)):
                words = {}
                for lane in range(32):
                    g, t = divmod(lane, 4)
                    addr = base(m0 + g + dm) + off(8 * s + dw) + t
                    assert off(8 * s + dw + t) == off(8 * s + dw) + t
                    words.setdefault(addr % 32, set()).add(addr)
                assert all(len(a) == 1 for a in words.values()), (m0, s)


def test_window_fits_its_pitch():
    """A's reach stays inside its row pair's 3 * COL_PAIRS words; M's rows
    fill 16 m16 tiles; the pool reads conv rows below M only."""
    assert max(base(m) % PITCH + off(47) % PITCH for m in range(M)) \
        < 3 * COL_PAIRS <= PITCH
    assert max(base(m) // PITCH + 3 for m in range(M)) == ROW_PAIRS - 1
    assert (M, M_PAD) == (255, 256)
    assert (2 * (TH - 1) + 2) * CW + 2 * (TW - 1) + 2 < M


def test_pool_threads_cover_the_tile():
    """The pool's threads (row group rg, column pc, channel group og; 256
    of them) write each of the tile's 7 x 8 pooled outputs x 8 channel
    groups once, from conv rows 4 rg .. 4 rg + 4 (rg 3: 12 .. 14), all
    inside the tile's 15 conv rows; pooled row 2 rg + k reads rows 2 (2 rg
    + k) .. + 2."""
    written = []
    for tid in range(256):
        og, pc, rg = tid % 8, tid // 8 % TW, tid // (8 * TW)
        nrows = 5 if 2 * rg + 1 < TH else 3
        rows = [4 * rg + i for i in range(nrows)]
        assert rows[-1] < CH
        for k in range(nrows // 2):
            pr = 2 * rg + k
            assert rows[2 * k:2 * k + 3] == [2 * pr, 2 * pr + 1, 2 * pr + 2]
            written.append((pr, pc, og))
    assert sorted(written) == [(pr, pc, og) for pr in range(TH)
                               for pc in range(TW) for og in range(8)]


@pytest.mark.parametrize("N,H,W,sms,tiles,ctas", [
    (128, 224, 224, 132, 128 * 56, 264),     # 56 x 56 pooled: 8 x 7 tiles
    (1, 37, 50, 132, 4, 4),                  # 10 x 13 pooled: 2 x 2
    (10, 224, 224, 132, 560, 264),
    (3, 1, 1, 132, 3, 3),
    (0, 224, 224, 132, 0, 0)])
def test_stem_plan(N, H, W, sms, tiles, ctas):
    assert stem_plan(N, H, W, sms) == (tiles, ctas)
    assert ctas <= STEM_CTAS_PER_SM * sms


# ---- K10: the int8 staging and the unpooled tile ------------------------

CTH, CTW = STEM_CONV_TILE              # conv outputs an unpooled tile
CM = CTH * CTW                         # its GEMM's rows: 256, no pad
C_ROW_PAIRS, C_COL_PAIRS = CTH + 3, CTW + 3
C_PITCH = row_pitch(C_COL_PAIRS, CTW)
OUT_ROW = STEM_OUT + 16                # bytes a row of the int8 output tile
# (1, 28, 16): even W, conv 14 x 8; (1, 31, 29): odd H and W (byte loads);
# (1, 37, 50): even W, odd H, partial tiles; (2, 64, 64): whole 16 x 16
# conv tiles.
K10_GEOMETRIES = [(1, 28, 16), (1, 31, 29), (1, 37, 50), (2, 64, 64)]


def c_off(w: int) -> int:
    return (w // 12) * C_PITCH + w % 12


def c_base(m: int) -> int:
    """Unpooled A row m's first word: conv position (m // 16, m % 16); an
    m16 tile is one conv row."""
    return (m // CTW) * C_PITCH + (m % CTW) * 3


def stage_int8(q: torch.Tensor, ch0: int, cw0: int, row_pairs: int,
               col_pairs: int, pitch: int, pairs: bool) -> torch.Tensor:
    """K10's staging of one window from the flat int8 images, as the
    kernel loads it: item (c, pair) reads its pair's two rows as 16-bit
    loads at even byte offsets (``pairs``: W even), or as four bytes, 0
    outside the image; word c of the pair holds (rp, cp) = (0,0), (0,1),
    (1,0), (1,1) from the lowest byte.  Returns the words, int64 [N,
    row_pairs * pitch]."""
    N, C, H, W = q.shape
    flat = q.reshape(N, -1)
    e = torch.arange(3 * row_pairs * col_pairs)
    c, p = e // (row_pairs * col_pairs), e % (row_pairs * col_pairs)
    ih = 2 * ch0 - 4 + 2 * (p // col_pairs)
    iw = 2 * cw0 - 4 + 2 * (p % col_pairs)
    assert (iw % 2 == 0).all()            # a pair starts on an even column
    word = torch.zeros((N, e.numel()), dtype=torch.int64)
    zero = torch.zeros((), dtype=torch.int64)
    if pairs:
        # W even: a pair's two columns lie both inside or both outside
        assert W % 2 == 0 and torch.equal(iw < W, iw + 1 < W)
        half = flat.view(torch.int16)
        for d in range(2):
            h = ih + d
            ok = (iw >= 0) & (iw < W) & (h >= 0) & (h < H)
            idx = torch.where(ok, (c * H + h) * W + iw, 0)
            assert (idx % 2 == 0).all()
            v = half[:, idx // 2].to(torch.int64) & 0xFFFF
            word |= torch.where(ok, v, zero) << (16 * d)
    else:
        for d in range(4):
            h, w = ih + d // 2, iw + d % 2
            ok = (w >= 0) & (w < W) & (h >= 0) & (h < H)
            idx = torch.where(ok, (c * H + h) * W + w, 0)
            v = flat[:, idx].to(torch.int64) & 0xFF
            word |= torch.where(ok, v, zero) << (8 * d)
    out = torch.zeros((N, row_pairs * pitch), dtype=torch.int64)
    out[:, (p // col_pairs) * pitch + (p % col_pairs) * 3 + c] = word
    return out


def words_of(win: torch.Tensor) -> torch.Tensor:
    """A window's bytes as its int32 words, unsigned in int64."""
    return win.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def tile_origins(H: int, W: int, pool: bool):
    """The first conv output (ch0, cw0) of every tile of an image."""
    if pool:
        Hp, Wp = stem_out_hw(H, W)
        return [(2 * oh0 - 1, 2 * ow0 - 1) for oh0 in range(0, Hp, TH)
                for ow0 in range(0, Wp, TW)]
    Hc, Wc = stem_conv_hw(H, W)
    return [(ch0, cw0) for ch0 in range(0, Hc, CTH)
            for cw0 in range(0, Wc, CTW)]


@pytest.mark.parametrize("pool", [True, False])
@pytest.mark.parametrize("N,H,W", K10_GEOMETRIES)
def test_int8_staging_equals_quantized_window(N, H, W, pool):
    """K10's words from the int8 images (16-bit loads where W is even, and
    the byte loads it takes at an odd address; bytes where W is odd) are
    the words K1 stages from the fp32 images they were quantized from."""
    x, _, _, _, scale = _case(N, H, W, seed=H + W)
    q = quantize_input(_t(x), scale)
    geom = ((ROW_PAIRS, COL_PAIRS, PITCH) if pool
            else (C_ROW_PAIRS, C_COL_PAIRS, C_PITCH))
    for ch0, cw0 in tile_origins(H, W, pool):
        want = words_of(window(q, ch0, cw0, *geom))
        for pairs in ((True, False) if W % 2 == 0 else (False,)):
            assert torch.equal(stage_int8(q, ch0, cw0, *geom, pairs), want)


def conv_a_index() -> torch.Tensor:
    """[256, 192] byte index of unpooled A's element (m, k) in the
    window."""
    return torch.tensor([[4 * (c_base(m) + c_off(k // 4)) + k % 4
                          for k in range(STEM_K)] for m in range(CM)])


def walk_conv(q, packed, bias, factors, check_acc=None):
    """Unpooled K10's output by the model: every 16 x 16 tile's window
    staged from the int8 images, its GEMM, relu(acc + bias) and the
    requant of every output, NCHW.  ``check_acc(acc, ch0, cw0)`` sees each
    tile's accumulators."""
    N, _, H, W = q.shape
    Hc, Wc = stem_conv_hw(H, W)
    out = torch.empty((N, STEM_OUT, Hc, Wc), dtype=torch.int8)
    idx = conv_a_index()
    for ch0, cw0 in tile_origins(H, W, False):
        words = stage_int8(q, ch0, cw0, C_ROW_PAIRS, C_COL_PAIRS, C_PITCH,
                           W % 2 == 0)
        win = (words - (words >= 2 ** 31) * 2 ** 32).to(torch.int32).view(
            torch.int8)
        acc = (win[:, idx].to(torch.int64) @ packed.to(torch.int64).t()
               ).to(torch.int32)
        if check_acc is not None:
            check_acc(acc, ch0, cw0)
        tile = requantize(acc, factors, relu=True, bias=bias).reshape(
            N, CTH, CTW, STEM_OUT).permute(0, 3, 1, 2)
        h, w = min(CTH, Hc - ch0), min(CTW, Wc - cw0)
        out[:, :, ch0:ch0 + h, cw0:cw0 + w] = tile[:, :, :h, :w]
    return out


@pytest.mark.parametrize("N,H,W", K10_GEOMETRIES)
def test_conv_walk_equals_plain(N, H, W):
    x, w2d, bias, f, scale = _case(N, H, W, seed=H * W + 1)
    w = _t(w2d.reshape(64, 3, 7, 7))
    q = quantize_input(_t(x), scale)
    Hc, Wc = stem_conv_hw(H, W)
    want_acc = matmul_int8_plain(
        im2col_nchw(q, 7, 2, 3).reshape(N * Hc * Wc, -1),
        w.reshape(64, -1).t()).reshape(N, Hc, Wc, 64)
    seen = torch.zeros((Hc, Wc), dtype=torch.int64)

    def check_acc(acc, ch0, cw0):
        m = torch.arange(CM)
        ch, cw = ch0 + m // CTW, cw0 + m % CTW
        ok = (ch < Hc) & (cw < Wc)
        assert torch.equal(acc[:, ok], want_acc[:, ch[ok], cw[ok]])
        seen[ch[ok], cw[ok]] += 1

    got = walk_conv(q, pack_stem_weight(w), _t(bias), _t(f), check_acc)
    # the disjoint tiles reach every conv output once
    assert bool((seen == 1).all())
    want = ops.stem_conv_pool_int8_plain(q, w, _t(bias), _t(f), pool=False)
    assert got.shape == want.shape
    assert torch.equal(got, want)


def test_conv_walk_equals_jax_fused_stem():
    """The unpooled model against the JAX fused stem (``pool=False``;
    interpret mode) on the fp32 images the int8 ones came from."""
    x, w2d, bias, f, scale = _case(2, 64, 64, seed=6)
    want = np.asarray(j_fused_stem(
        jnp.asarray(x), jnp.asarray(w2d), jnp.asarray(bias), jnp.asarray(f),
        scale, pool=False, interpret=True))
    got = walk_conv(quantize_input(_t(x), scale),
                    pack_stem_weight(_t(w2d.reshape(64, 3, 7, 7))),
                    _t(bias), _t(f))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_conv_tile_a_loads_free_of_bank_conflicts():
    """As test_a_loads_free_of_bank_conflicts, for the unpooled tile at
    its pitch of 3 x 19 words: an m16 tile is one conv row, so no load
    crosses a row's end."""
    assert C_PITCH == 3 * C_COL_PAIRS == 57
    for m0 in range(0, CM, 16):
        for s in range(6):
            for dm, dw in ((0, 0), (8, 0), (0, 4), (8, 4)):
                words = {}
                for lane in range(32):
                    g, t = divmod(lane, 4)
                    addr = c_base(m0 + g + dm) + c_off(8 * s + dw) + t
                    words.setdefault(addr % 32, set()).add(addr)
                assert all(len(a) == 1 for a in words.values()), (m0, s)


def test_conv_tile_fits_its_pitch():
    """A's reach stays inside its row pair's 3 * 19 words; M's 256 rows
    are 16 whole m16 tiles; the window's row pairs are all read."""
    assert max(c_base(m) % C_PITCH + c_off(47) % C_PITCH
               for m in range(CM)) < 3 * C_COL_PAIRS
    assert max(c_base(m) // C_PITCH + 3 for m in range(CM)) \
        == C_ROW_PAIRS - 1
    assert CM == 256


def test_output_tile_free_of_bank_conflicts():
    """The unpooled epilogue's 2-byte stores into the int8 output tile
    (80-byte rows; warp (nh, mw), m16 tile mt, half h, column group j:
    lane (g, t) at byte m * 80 + 32 nh + 8 j + 2 t) touch each bank at
    most once or one word from several lanes; the store's lanes (pixel 8
    (v / 32) + v % 8, part v / 8 % 4) take each pixel's four 16-byte parts
    once, a quarter warp's reads hit 8 distinct 4-bank groups, and a
    warp's global stores are 512 contiguous bytes of one output row."""
    for warp in range(8):
        nh, mw = warp % 2, warp // 2
        for mt in range(mw, CM // 16, 4):
            for h in range(2):
                for j in range(4):
                    words = {}
                    for lane in range(32):
                        g, t = divmod(lane, 4)
                        m = 16 * mt + g + 8 * h
                        addr = (m * OUT_ROW + 32 * nh + 8 * j + 2 * t) // 4
                        words.setdefault(addr % 32, set()).add(addr)
                    assert all(len(a) == 1 for a in words.values())
    lanes = [((v // 32) * 8 + v % 8, v // 8 % 4) for v in range(4 * CM)]
    assert sorted(lanes) == [(pix, part) for pix in range(CM)
                             for part in range(4)]
    for v0 in range(0, 4 * CM, 8):
        assert len({(pix * OUT_ROW + 16 * part) // 16 % 8
                    for pix, part in lanes[v0:v0 + 8]}) == 8
    for v0 in range(0, 4 * CM, 32):
        warp = lanes[v0:v0 + 32]
        assert len({pix // CTW for pix, _ in warp}) == 1
        offs = sorted((pix % CTW) * STEM_OUT + 16 * part
                      for pix, part in warp)
        assert offs == list(range(offs[0], offs[0] + 512, 16))


@pytest.mark.parametrize("N,H,W,sms,tiles,ctas", [
    (128, 224, 224, 132, 128 * 49, 264),     # 112 x 112 conv: 7 x 7 tiles
    (1, 37, 50, 132, 4, 4),                  # 19 x 25 conv: 2 x 2
    (12, 224, 224, 132, 588, 264),
    (3, 1, 1, 132, 3, 3),
    (0, 224, 224, 132, 0, 0)])
def test_stem_plan_unpooled(N, H, W, sms, tiles, ctas):
    assert stem_plan(N, H, W, sms, pool=False) == (tiles, ctas)
