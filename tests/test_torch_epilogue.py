"""PyTorch port: the reference's Q16.16 requant, the power-of-two
reciprocal, ``relu_int8``, ``relu6_int8`` (its overflow below a scale of
6 / 127 included) and ``dequantize_output`` against the numpy golden and
the JAX package, bit for bit.

The cases are those of ``tests/test_golden_ops.py`` (Q16.16),
``tests/test_native.py`` and ``tests/test_ops_tpu.py`` (the full int32
range) and ``tests/test_inv_requant.py`` (``exact_pow2_inv``), with the
one deliberate difference: a scale whose reciprocal is not a normal
float32 gets None from the port.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from resnet_accel_tpu import golden as G
from resnet_accel_tpu.ops import epilogue as JE
from resnet_accel_tpu_torch import golden
from resnet_accel_tpu_torch.ops import (dequantize_output, exact_pow2_inv,
                                        relu6_int8, relu_int8,
                                        requantize_q16)
from resnet_accel_tpu_torch.quant import pow2_scale

torch.set_num_threads(2)

SCALES_Q16 = [0x0001, 0x1234, 0x8000, 0xFFFF, 0x18000, 0x2ABCD]


def _acc(seed):
    x = np.random.default_rng(seed).integers(-(2**31), 2**31, 4096)
    return np.concatenate(
        [x, [2**31 - 1, -(2**31), 0, -1, 1, 65535, -65536, -65537]]
    ).astype(np.int32)


@pytest.mark.parametrize("scale", [0.5, 1.0, 1.5, 0.0000076, 0.013,
                                   3 / 127, 2.5, 65535.99, 1e-9])
def test_scale_to_q16_matches_golden(scale):
    assert golden.scale_to_q16(scale) == G.scale_to_q16(scale)
    q = golden.scale_to_q16(scale)
    assert golden.q16_to_scale(q) == G.q16_to_scale(q)


def test_q16_known_values():
    assert golden.scale_to_q16(0.5) == 0x8000
    assert golden.scale_to_q16(1.0) == 0x10000
    assert golden.scale_to_q16(0.0000076) == 0
    assert golden.q16_to_scale(0x18000) == 0.5


@pytest.mark.parametrize("scale_q16", SCALES_Q16)
@pytest.mark.parametrize("relu", [False, True])
def test_requantize_q16_matches_golden_and_jax(scale_q16, relu):
    acc = _acc(scale_q16 & 0xFF)
    got = requantize_q16(torch.from_numpy(acc), scale_q16, relu=relu)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(
        got.numpy(), G.requantize_q16(acc, scale_q16, relu=relu))
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(JE.requantize_q16(jnp.asarray(acc), scale_q16, relu)))


def test_requantize_q16_vectors():
    """Floor, not round; the fraction bits only; ReLU before the scale."""
    x = torch.tensor([0, 1, 2, 3, -1, -2, -3, 255], dtype=torch.int32)
    assert requantize_q16(x, 0x8000).tolist() == [0, 0, 1, 1, -1, -1, -2,
                                                  127]
    x = torch.tensor([-1, -65536, -65537], dtype=torch.int32)
    assert requantize_q16(x, 0x0001).tolist() == [-1, -1, -2]
    x = torch.tensor([100, -100], dtype=torch.int32)
    assert torch.equal(requantize_q16(x, 0x18000), requantize_q16(x, 0x8000))
    assert requantize_q16(x, 0x10000).tolist() == [0, 0]
    x = torch.tensor([-1000, 1000], dtype=torch.int32)
    assert requantize_q16(x, 0xFFFF, relu=True).tolist() == [0, 127]


def test_exact_pow2_inv_matches_jax():
    for k in range(-20, 21):
        s = float(2.0 ** k)
        inv = exact_pow2_inv(s)
        assert inv == JE.exact_pow2_inv(s) == 1.0 / s
        rng = np.random.default_rng(k + 100)
        x = np.concatenate([
            rng.normal(0, 1, 4096).astype(np.float32),
            (rng.integers(-200, 200, 512).astype(np.float32) + 0.5) * s,
            np.float32([1e-38, -1e-38, 3e38, -3e38, 0.0]),
        ]).astype(np.float32)
        xt = torch.from_numpy(x)
        assert torch.equal(xt / torch.tensor(np.float32(s)),
                           xt * torch.tensor(np.float32(inv)))
    for s in (3 / 127, 0.1, 0.05, 1e-12, 0.75, 0.0, -1.0, float("inf"),
              float("nan")):
        assert exact_pow2_inv(s) is None
        assert JE.exact_pow2_inv(s) is None
    for s in (3 / 127, 0.1, 1e-9, 123.4):
        assert exact_pow2_inv(pow2_scale(s)) == JE.exact_pow2_inv(
            pow2_scale(s)) is not None


def test_exact_pow2_inv_refuses_subnormal_reciprocal():
    """The port's one difference from JAX: 2^127's reciprocal, 2^-127, is
    subnormal, so the port gives None where JAX gives it; 2^126's
    reciprocal is the smallest normal float32 and both give it."""
    assert JE.exact_pow2_inv(2.0 ** 127) == 2.0 ** -127
    assert exact_pow2_inv(2.0 ** 127) is None
    assert exact_pow2_inv(2.0 ** 126) == JE.exact_pow2_inv(2.0 ** 126) \
        == float(np.finfo(np.float32).tiny)


def _int8_cases(seed):
    x = np.random.default_rng(seed).integers(-128, 128, (3, 5, 7))
    return np.concatenate([x.reshape(-1), [-128, -1, 0, 1, 127]]).astype(
        np.int8)


@pytest.mark.parametrize("dtype", [np.int8, np.int32])
def test_relu_int8_matches_jax(dtype):
    x = _int8_cases(1).astype(dtype)
    got = relu_int8(torch.from_numpy(x))
    want = np.asarray(JE.relu_int8(jnp.asarray(x)))
    assert got.dtype == torch.int8 and want.dtype == np.int8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), G.relu_int8(
        x.astype(np.int8)))


@pytest.mark.parametrize("scale", [6 / 127, 0.05, 0.1, 0.2, 0.5,
                                   1.0, 7.0])
def test_relu6_int8_matches_jax_and_golden(scale):
    x = _int8_cases(2)
    got = relu6_int8(torch.from_numpy(x), scale)
    want = np.asarray(JE.relu6_int8(jnp.asarray(x), scale))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), G.relu6_int8(x, scale))


@pytest.mark.parametrize("scale", [0.01, 6 / 128])
def test_relu6_int8_bound_out_of_int8_raises_as_jax(scale):
    """Below 6 / 127 the truncated bound leaves int8: at 0.01 it is 600,
    and the JAX op, the golden and the port raise the same error."""
    x = _int8_cases(3)
    with pytest.raises(OverflowError) as jerr:
        JE.relu6_int8(jnp.asarray(x), scale)
    with pytest.raises(OverflowError) as gerr:
        G.relu6_int8(x, scale)
    with pytest.raises(OverflowError) as perr:
        relu6_int8(torch.from_numpy(x), scale)
    assert str(perr.value) == str(jerr.value) == str(gerr.value)
    if scale == 0.01:
        assert "600 out of bounds for int8" in str(perr.value)


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("dtype", [np.int8, np.int32])
def test_dequantize_output_matches_jax(per_channel, dtype):
    rng = np.random.default_rng(4)
    x = rng.integers(-(2 ** 20), 2 ** 20, (6, 10)).astype(dtype) \
        if dtype == np.int32 else _int8_cases(4)[:60].reshape(6, 10)
    scale = (rng.uniform(1e-4, 0.3, 10).astype(np.float32) if per_channel
             else 0.0123456789)
    got = dequantize_output(torch.from_numpy(x), scale)
    want = np.asarray(JE.dequantize_output(jnp.asarray(x), scale))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)
