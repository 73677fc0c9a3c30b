"""PyTorch port: K1's walk over its tiles, on the CPU.

K1 (``csrc/stem_fused.cu``) runs the stem's 7x7/s2/p3 conv as an int8
GEMM over a space-to-depth window in shared memory: a tile is one image's
7 x 8 pooled outputs over the 15 x 17 conv outputs under them (M = 255,
padded to 256 rows); its window holds the quantized input as [row
pair][column pair][12 bytes], the pairs counted from the window's own
origin ``2 * ch0 - 4``; A's word w of row m is read at ``base(m) +
off(w)`` words; B is :func:`pack_stem_weight`'s [64, 192].  The model
below is that walk in PyTorch, and the tests hold it to the plain
version: its accumulators to the int32 sums of ``im2col_nchw`` and the
exact GEMM (the sums inside ``conv2d_int8_plain``), and its conv tile
pushed through the pool and the requant to ``stem_conv_pool_plain``, at
geometries with both window-origin parities, odd sizes and M's pad row,
and once to the JAX package's ``stem_conv_pool_nm``.  Exact: integer
sums and indexing.  The kernel itself is held to the plain version on the
card (``test_stem`` in tests/test_torch_kernels.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from resnet_accel_tpu.ops.conv import stem_s2d_weights as j_stem_s2d_weights
from resnet_accel_tpu.ops.stem_fused import stem_conv_pool_nm
from resnet_accel_tpu_torch import ops
from resnet_accel_tpu_torch.ops.conv import im2col_nchw, stem_s2d_weights
from resnet_accel_tpu_torch.ops.epilogue import quantize_input, requantize
from resnet_accel_tpu_torch.ops.matmul_int8 import matmul_int8_plain
from resnet_accel_tpu_torch.ops.stem_fused import (
    STEM_CTAS_PER_SM, STEM_K, STEM_OUT, STEM_TILE, pack_stem_weight,
    stem_out_hw, stem_plan, unpack_stem_weight)

torch.set_num_threads(2)

TH, TW = STEM_TILE
CH, CW = 2 * TH + 1, 2 * TW + 1        # conv rows, cols under a tile
M = CH * CW                            # the GEMM's rows
M_PAD = -(-M // 16) * 16               # in m16 tiles
ROW_PAIRS, COL_PAIRS = CH + 3, CW + 3  # of the s2d window


def row_pitch() -> int:
    """The kernel's ``kPitch``: words a row pair, at least 3 a column pair,
    = 3 * CW + 1 mod 32."""
    p = 3 * COL_PAIRS
    while p % 32 != (3 * CW + 1) % 32:
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


def tile_window(xq: torch.Tensor, oh0: int, ow0: int) -> torch.Tensor:
    """The staged window of the tile at pooled (oh0, ow0): [N, ROW_PAIRS *
    PITCH * 4] bytes, pair (i, j)'s 12 bytes (c, rp, cp) at word i * PITCH
    + 3 j, input row 2 * ch0 - 4 + 2 i + rp, 0 outside the image."""
    N, C, H, W = xq.shape
    ih0, iw0 = 2 * (2 * oh0 - 1) - 4, 2 * (2 * ow0 - 1) - 4
    canvas = torch.zeros((N, C, 2 * ROW_PAIRS, 2 * COL_PAIRS),
                         dtype=torch.int8)
    h0, h1 = max(ih0, 0), min(ih0 + 2 * ROW_PAIRS, H)
    w0, w1 = max(iw0, 0), min(iw0 + 2 * COL_PAIRS, W)
    if h0 < h1 and w0 < w1:
        canvas[:, :, h0 - ih0:h1 - ih0, w0 - iw0:w1 - iw0] = \
            xq[:, :, h0:h1, w0:w1]
    pairs = canvas.reshape(N, C, ROW_PAIRS, 2, COL_PAIRS, 2).permute(
        0, 2, 4, 1, 3, 5)
    window = torch.zeros((N, ROW_PAIRS, PITCH * 4), dtype=torch.int8)
    window[:, :, :COL_PAIRS * 12] = pairs.reshape(N, ROW_PAIRS, COL_PAIRS * 12)
    return window.reshape(N, -1)


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
    x, w2d, bias, f, scale = _case(2, 20, 23, seed=11)
    w = _t(w2d.reshape(64, 3, 7, 7))
    args = (_t(bias), _t(f), scale)
    assert torch.equal(ops.stem_conv_pool(_t(x), pack_stem_weight(w), *args),
                       ops.stem_conv_pool_plain(_t(x), w, *args))


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
