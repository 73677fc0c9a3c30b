"""PyTorch port: the JAX package's layout-specific 3x3 conv routes, the
batch-minor ``conv_bm`` kernels and the pixel-major ``conv_pm`` kernels,
against the port's ``conv2d_int8`` (its plain version on the CPU), bit
for bit (tolerance 0).

Those kernels compute K2's function -- a 3x3/s1/p1 int8 conv with the
requant epilogue, optionally joined to a residual -- in layouts the port
does not use, so they close against K2: each runs in interpret mode at the
shapes of ``tests/test_conv_bm.py`` and ``tests/test_conv_pm.py``, its
output is converted back to NCHW with the JAX helpers, and held against one
``conv2d_int8`` call (for ``block3x3_bm``, c1 with ReLU, then c2 with the
join).  K2 itself is held to its plain version on the card at the same
shapes in ``tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from resnet_accel_tpu.ops import conv_bm, conv_pm
from resnet_accel_tpu.ops.epilogue import exact_inv_out_scale
from resnet_accel_tpu_torch.ops import conv2d_int8, pack_weight

torch.set_num_threads(2)


def _port_conv(x, w2d, bias, f, relu, residual=None, res_scales=None):
    c = x.shape[1]
    return conv2d_int8(
        torch.from_numpy(x), pack_weight(w2d, c, 3, "cpu"),
        torch.from_numpy(bias), torch.from_numpy(f), padding=1, relu=relu,
        residual=None if residual is None else torch.from_numpy(residual),
        res_scales=res_scales)


def _bm_layer(seed, N=128, H=8, W=8, C=64):
    """tests/test_conv_bm.py::_mk"""
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (N, C, H, W)).astype(np.int8)
    w2d = rng.integers(-64, 64, (C, C * 9)).astype(np.int8)
    bias = rng.integers(-8000, 8000, C).astype(np.int32)
    f = rng.uniform(0.001, 0.01, C).astype(np.float32)
    return x, w2d, bias, f


def _invs(scales):
    """No reciprocal, and the proven one where the proof holds."""
    proof = exact_inv_out_scale(*scales)
    return [None] + ([proof] if proof is not None else [])


@pytest.mark.parametrize("relu", [True, False])
def test_conv3x3_bm(relu):
    x, w2d, bias, f = _bm_layer(1)
    out = conv_bm.conv3x3_bm(
        conv_bm.rowvec_of_nchw(jnp.asarray(x)),
        conv_bm.pack_weights_bm(w2d, 64), jnp.asarray(bias), jnp.asarray(f),
        width=8, relu=relu, kernel_interpret=True)
    got = _port_conv(x, w2d, bias, f, relu)
    np.testing.assert_array_equal(
        np.asarray(conv_bm.nchw_of_rowvec(out, 128)), got.numpy())


def test_conv3x3_bm_residual_join():
    x, w2d, bias, f = _bm_layer(2)
    r = _bm_layer(4)[0]
    scales = (0.11, 0.07, 0.15)
    want = _port_conv(x, w2d, bias, f, False, r, scales).numpy()
    xr, rr = (conv_bm.rowvec_of_nchw(jnp.asarray(a)) for a in (x, r))
    w9 = conv_bm.pack_weights_bm(w2d, 64)
    for inv in _invs(scales):
        out = conv_bm.conv3x3_bm(xr, w9, jnp.asarray(bias), jnp.asarray(f),
                                 width=8, relu=True, residual=rr,
                                 res_scales=(*scales, inv),
                                 kernel_interpret=True)
        np.testing.assert_array_equal(
            np.asarray(conv_bm.nchw_of_rowvec(out, 128)), want)


def test_block3x3_bm():
    x, w2d1, b1, f1 = _bm_layer(8)
    _, w2d2, b2, f2 = _bm_layer(9)
    scales = (0.13, 0.06, 0.17)
    y1 = _port_conv(x, w2d1, b1, f1, True).contiguous().numpy()
    want = _port_conv(y1, w2d2, b2, f2, False, x, scales).numpy()
    xr = conv_bm.rowvec_of_nchw(jnp.asarray(x))
    w91, w92 = (conv_bm.pack_weights_bm(w, 64) for w in (w2d1, w2d2))
    for inv in _invs(scales):
        out = conv_bm.block3x3_bm(
            xr, w91, jnp.asarray(b1), jnp.asarray(f1), w92, jnp.asarray(b2),
            jnp.asarray(f2), width=8, res_scales=(*scales, inv),
            kernel_interpret=True)
        np.testing.assert_array_equal(
            np.asarray(conv_bm.nchw_of_rowvec(out, 128)), want)


def _pm_layer(rng, c):
    """tests/test_conv_pm.py::_rand_layer"""
    w = rng.integers(-128, 128, size=(c, c, 3, 3), dtype=np.int8)
    bias = rng.integers(-1000, 1000, size=(c,), dtype=np.int32)
    factors = (rng.random(c).astype(np.float32) * 0.01 + 1e-3)
    return w.reshape(c, c * 9), bias, factors.astype(np.float32)


@pytest.mark.parametrize("c,h,w_sp", [(8, 6, 5), (16, 4, 3)])
def test_conv3x3_pm(c, h, w_sp):
    rng = np.random.default_rng(c)
    x = rng.integers(-128, 128, size=(128, c, h, w_sp), dtype=np.int8)
    w2d, bias, f = _pm_layer(rng, c)
    out = conv_pm.conv3x3_pm(
        conv_pm.to_pixel_major(jnp.asarray(x)),
        jnp.asarray(conv_pm.pack_g3(w2d, c)), jnp.asarray(bias),
        jnp.asarray(f), n=128, relu=True, interpret=True)
    np.testing.assert_array_equal(
        np.asarray(conv_pm.from_pixel_major(out, 128)),
        _port_conv(x, w2d, bias, f, True).numpy())


def test_conv3x3_pm_residual_join():
    rng = np.random.default_rng(7)
    c, h, w_sp, scales = 8, 5, 4, (0.03, 0.02, 0.05)
    x = rng.integers(-128, 128, size=(128, c, h, w_sp), dtype=np.int8)
    res = rng.integers(-128, 128, size=(128, c, h, w_sp), dtype=np.int8)
    w2d, bias, f = _pm_layer(rng, c)
    out = conv_pm.conv3x3_pm(
        conv_pm.to_pixel_major(jnp.asarray(x)),
        jnp.asarray(conv_pm.pack_g3(w2d, c)), jnp.asarray(bias),
        jnp.asarray(f), n=128, relu=False,
        residual=conv_pm.to_pixel_major(jnp.asarray(res)),
        res_scales=scales, interpret=True)
    np.testing.assert_array_equal(
        np.asarray(conv_pm.from_pixel_major(out, 128)),
        _port_conv(x, w2d, bias, f, False, res, scales).numpy())


@pytest.mark.parametrize("c,h,w_sp,join", [(8, 6, 5, False),
                                           (8, 4, 3, True)])
def test_conv3x3_pm2(c, h, w_sp, join):
    """The pair-plane kernel, plain (seed 11) and with the join (seed 13,
    the irregular scales of tests/test_conv_pm.py)."""
    rng = np.random.default_rng(13 if join else 11)
    x = rng.integers(-128, 128, size=(128, c, h, w_sp), dtype=np.int8)
    res = (rng.integers(-128, 128, size=(128, c, h, w_sp), dtype=np.int8)
           if join else None)
    w2d, bias, f = _pm_layer(rng, c)
    scales = (0.043719, 0.029153, 0.061347) if join else None
    kw = {}
    if join:
        kw = dict(residual=conv_pm.to_pm_planes(jnp.asarray(res)),
                  res_scales=scales)
    xe, xo = conv_pm.to_pm_planes(jnp.asarray(x))
    oe, oo = conv_pm.conv3x3_pm2(
        xe, xo, jnp.asarray(conv_pm.pack_g3_pair(w2d, c)), jnp.asarray(bias),
        jnp.asarray(f), n=128, relu=not join, interpret=True, **kw)
    np.testing.assert_array_equal(
        np.asarray(conv_pm.from_pm_planes(oe, oo, 128)),
        _port_conv(x, w2d, bias, f, not join, res, scales).numpy())
