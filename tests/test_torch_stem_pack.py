"""PyTorch port: the fused quantize + space-to-depth (K6's plain version on
the CPU), the space-to-depth ops and the per-side padded conv against the
JAX package, bit for bit (tolerance 0).

Ports ``tests/test_stem_pack.py`` and ``tests/test_stem_s2d.py``: the JAX
``quantize_s2d_nm`` and ``quantize_s2d_wh`` run their Pallas kernels in
interpret mode.  The quantize is one IEEE f32 divide and a round to even
per value, so ties ``(k + 0.5) * s`` and saturation are where a
reciprocal multiply or another rounding would show.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from resnet_accel_tpu.ops import conv as JC
from resnet_accel_tpu.ops import stem_pack as JS
from resnet_accel_tpu_torch import ops
from resnet_accel_tpu_torch.ops.matmul_int8 import matmul_int8_plain

torch.set_num_threads(2)


def _images(shape, s, seed):
    """Normal images with exact ties and values past the int8 range."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 60 * s, shape).astype(np.float32)
    flat = x.reshape(-1)
    k = rng.integers(-140, 140, flat.size // 3).astype(np.float32)
    flat[::3] = (k + np.float32(0.5)) * np.float32(s)
    flat[1::7] = np.float32(300 * s) * np.sign(flat[1::7])
    return x


@pytest.mark.parametrize("shape", [(2, 3, 12, 16), (1, 3, 8, 8),
                                   (4, 3, 32, 32), (3, 4, 6, 10)])
def test_quantize_s2d_matches_jax(shape):
    s = 0.0173
    x = _images(shape, s, sum(shape))
    xj = jnp.asarray(x)
    got = ops.quantize_s2d(torch.from_numpy(x), s)
    assert got.dtype == torch.int8
    assert got.shape == (shape[0], 4 * shape[1], shape[2] // 2,
                         shape[3] // 2)
    nm = np.asarray(JS.quantize_s2d_nm(xj, s, interpret=True))
    np.testing.assert_array_equal(got.numpy(), nm)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JS.quantize_s2d_nchw(xj, s)))
    np.testing.assert_array_equal(
        ops.quantize_s2d_nchw(torch.from_numpy(x), s).numpy(), nm)
    wh = ops.quantize_s2d_wh(torch.from_numpy(x), s)
    np.testing.assert_array_equal(
        wh.numpy(), np.asarray(JS.quantize_s2d_wh(xj, s, interpret=True)))


def test_quantize_divides_and_rounds_to_even():
    """0.15 / 0.1 rounds apart from 0.15 * (1 / 0.1) in float32; every
    tie goes to the even neighbour; saturation clips."""
    s = np.float32(0.1)
    k = np.arange(-150, 150, dtype=np.float32)
    x = np.concatenate([np.full(4, 0.15, np.float32), (k + 0.5) * s,
                        np.float32([1e9, -1e9, 0.0, -0.0])])
    x = np.resize(x, (1, 2, 16, 20)).astype(np.float32)
    got = ops.quantize_s2d(torch.from_numpy(x), float(s)).numpy()
    want = np.clip(np.rint(x / s), -128, 127).astype(np.int8)
    want = want.reshape(1, 2, 8, 2, 10, 2).transpose(0, 1, 3, 5, 2, 4)
    np.testing.assert_array_equal(got, want.reshape(1, 8, 8, 10))
    assert int(got[0, 0, 0, 0]) == int(np.rint(np.float32(0.15) / s))


@pytest.mark.parametrize("fn", [ops.quantize_s2d, ops.quantize_s2d_nchw,
                                ops.quantize_s2d_wh])
@pytest.mark.parametrize("hw", [(7, 8), (8, 7)])
def test_quantize_s2d_rejects_odd(fn, hw):
    with pytest.raises(ValueError, match="even"):
        fn(torch.zeros((1, 3, *hw)), 0.1)


def test_space_to_depth_matches_jax():
    x = np.arange(2 * 3 * 4 * 6, dtype=np.int8).reshape(2, 3, 4, 6)
    got = ops.space_to_depth_nchw(torch.from_numpy(x))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JC.space_to_depth_nchw(jnp.asarray(x))))
    # channel c*4 + rp*2 + cp holds x[c, 2i + rp, 2j + cp]
    np.testing.assert_array_equal(got[0, 7].numpy(), x[0, 1, 1::2, 1::2])
    assert torch.equal(got, F.pixel_unshuffle(torch.from_numpy(x), 2))


@pytest.mark.parametrize("in_c,kernel", [(3, 7), (4, 7), (3, 3), (2, 5)])
def test_stem_s2d_weights_matches_jax(in_c, kernel):
    w = np.random.default_rng(kernel).integers(
        -128, 128, (8, in_c * kernel * kernel)).astype(np.int8)
    got = ops.stem_s2d_weights(w, in_c, kernel)
    k2 = (kernel + 1) // 2
    assert got.shape == (8, 4 * in_c * k2 * k2) and got.dtype == np.int8
    np.testing.assert_array_equal(
        got, np.asarray(JC.stem_s2d_weights(w, in_c, kernel)))


def test_stem_s2d_weights_refuses_even_kernel():
    with pytest.raises(ValueError, match="odd"):
        ops.stem_s2d_weights(np.zeros((4, 3 * 16), np.int8), 3, 4)


def test_transpose_taps_matches_jax():
    w = np.random.default_rng(2).integers(-128, 128, (8, 27)).astype(
        np.int8)
    t = ops.transpose_taps(w, 3, 3)
    np.testing.assert_array_equal(
        t, np.asarray(JS.transpose_taps(jnp.asarray(w), 3, 3)))
    np.testing.assert_array_equal(ops.transpose_taps(t, 3, 3), w)


@pytest.mark.parametrize("H,W", [(32, 32), (30, 22)])
def test_s2d_conv_equals_direct_7x7(H, W):
    """The 4x4/s1 conv padded ((2, 1), (2, 1)) on the regrouped input and
    weights has the int32 sums of the 7x7/s2/p3 conv, and so the bits of
    the requantized one, here and in JAX."""
    rng = np.random.default_rng(H + W)
    O, C = 64, 3
    w2d = rng.integers(-128, 128, (O, C * 49)).astype(np.int8)
    x = rng.integers(-128, 128, (2, C, H, W)).astype(np.int8)
    ws = ops.stem_s2d_weights(w2d, C, 7)
    xt = torch.from_numpy(x)
    s = ops.space_to_depth_nchw(xt)
    pad = ((2, 1), (2, 1))
    direct = matmul_int8_plain(
        ops.im2col_nchw(xt, 7, 2, 3).reshape(-1, C * 49),
        torch.from_numpy(w2d).t())
    via_s2d = matmul_int8_plain(
        ops.im2col_nchw(s, 4, 1, pad).reshape(-1, 4 * C * 16),
        torch.from_numpy(ws).t())
    assert torch.equal(via_s2d, direct)
    ref = np.asarray(JC.conv2d_int8(jnp.asarray(x), jnp.asarray(w2d),
                                    kernel=7, stride=2, padding=3))
    np.testing.assert_array_equal(
        direct.reshape(2, H // 2, W // 2, O).permute(0, 3, 1, 2).numpy(),
        ref)
    bias = torch.from_numpy(rng.integers(-5000, 5000, O).astype(np.int32))
    f = torch.from_numpy(rng.uniform(1e-5, 1e-4, O).astype(np.float32))
    a = ops.conv2d_int8(s, ops.pack_weight(ws, 4 * C, 4, "cpu"), bias, f,
                        padding=pad, relu=True)
    b = ops.conv2d_int8(xt, ops.pack_weight(w2d, C, 7, "cpu"), bias, f,
                        stride=2, padding=3, relu=True)
    assert a.shape == (2, O, H // 2, W // 2) and torch.equal(a, b)


@pytest.mark.parametrize("pad", [((2, 1), (2, 1)), ((0, 2), (1, 0)),
                                 ((1, 1), (1, 1))])
@pytest.mark.parametrize("relu", [False, True])
def test_conv_per_side_padding_matches_jax(pad, relu):
    rng = np.random.default_rng(sum(sum(p) for p in pad))
    C, O, k = 12, 16, 4 if pad[0] == (2, 1) else 3
    x = rng.integers(-128, 128, (2, C, 9, 11)).astype(np.int8)
    w = rng.integers(-128, 128, (O, C * k * k)).astype(np.int8)
    bias = rng.integers(-3000, 3000, O).astype(np.int32)
    f = (rng.uniform(0.5, 1.5, O) * 0.011 / np.sqrt(C * k * k)).astype(
        np.float32)
    got = ops.conv2d_int8_plain(
        torch.from_numpy(x), ops.pack_weight(w, C, k, "cpu"),
        torch.from_numpy(bias), torch.from_numpy(f), padding=pad, relu=relu)
    ref = np.asarray(JC.conv2d_int8(
        jnp.asarray(x), jnp.asarray(w), bias=jnp.asarray(bias), kernel=k,
        stride=1, padding=pad, factors=jnp.asarray(f), relu=relu))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), ref)
    if pad == ((1, 1), (1, 1)):     # the pairs and the int are one padding
        assert torch.equal(got, ops.conv2d_int8_plain(
            torch.from_numpy(x), ops.pack_weight(w, C, k, "cpu"),
            torch.from_numpy(bias), torch.from_numpy(f), padding=1,
            relu=relu))
