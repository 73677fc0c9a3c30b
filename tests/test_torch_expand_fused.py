"""PyTorch port: the fused bottleneck expansion (K7's wrapper and its plain
version) against the JAX package's kernel.

Mirrors tests/test_expand_fused.py.  ``expand_add_int8_plain`` is
bit-identical (tolerance 0) to the JAX ``expand_add_int8`` run in Pallas
interpret mode -- the kernel the TPU compiles -- at the JAX test's three
shapes (batch 128, the TPU kernel's gate), and to the JAX kernel's
reciprocal multiply where ``exact_inv_out_scale`` proves it equal to the
divide, and given the same ``inv_out`` (the proof, or None at a triple
with none) the two agree too.  On CPU tensors ``expand_add_int8`` runs
the plain version, which is the composition ``conv2d_int8_plain`` at
kernel 1 followed by ``add_residual``, bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from resnet_accel_tpu.ops.epilogue import exact_inv_out_scale
from resnet_accel_tpu.ops.expand_fused import expand_add_int8 as jax_expand
from resnet_accel_tpu_torch import ops

torch.set_num_threads(2)

CL = torch.channels_last


def _case(seed, n, cin, cout, h, w):
    """int8 x [n, cin, h, w], w [cout, cin], residual [n, cout, h, w],
    int32 bias and float32 factors, as numpy arrays."""
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.integers(-128, 128, (n, cin, h, w)).astype(np.int8),
        w=rng.integers(-128, 128, (cout, cin)).astype(np.int8),
        b=rng.integers(-1000, 1000, (cout,)).astype(np.int32),
        f=rng.uniform(0.001, 0.01, (cout,)).astype(np.float32),
        r=rng.integers(-128, 128, (n, cout, h, w)).astype(np.int8))


def _port(c, scales, fn=ops.expand_add_int8_plain, **kw):
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    return fn(t["x"].contiguous(memory_format=CL), t["w"], t["b"], t["f"],
              t["r"].contiguous(memory_format=CL), *scales, **kw)


def _jax(c, scales, inv=None):
    return np.asarray(jax_expand(
        jnp.asarray(c["x"]), jnp.asarray(c["w"]), jnp.asarray(c["b"]),
        jnp.asarray(c["f"]), jnp.asarray(c["r"]), *scales, inv_out=inv,
        interpret=True))


@pytest.mark.parametrize("cin,cout,h,w", [(16, 32, 4, 5), (8, 16, 3, 7),
                                          (32, 64, 2, 2)])
def test_plain_bit_exact_vs_jax_kernel(cin, cout, h, w):
    c = _case(cin + h, 128, cin, cout, h, w)
    scales = (0.05, 0.061, 0.043)
    got = _port(c, scales)
    assert got.dtype == torch.int8 and got.is_contiguous(memory_format=CL)
    np.testing.assert_array_equal(got.numpy(), _jax(c, scales))


def test_plain_matches_jax_verified_reciprocal():
    """The port divides; JAX multiplies by the proven reciprocal: equal."""
    scales = (0.05, 0.06, 0.07)
    inv = exact_inv_out_scale(*scales)
    assert inv is not None
    c = _case(3, 128, 16, 32, 4, 4)
    np.testing.assert_array_equal(_port(c, scales).numpy(),
                                  _jax(c, scales, inv=inv))


#: A scale triple with no exact_inv_out_scale proof: the join must divide.
NO_PROOF = (1.644742727279663, 0.680426299571991, 1.3817954063415527)


@pytest.mark.parametrize("cin,cout,h,w", [(16, 32, 4, 5), (8, 16, 3, 7),
                                          (32, 64, 2, 2)])
@pytest.mark.parametrize("scales", [(0.05, 0.061, 0.043), NO_PROOF],
                         ids=["proof", "no_proof"])
def test_plain_inv_out_matches_jax_kernel(cin, cout, h, w, scales):
    """``inv_out`` as the JAX signature has it: the proven reciprocal where
    ``exact_inv_out_scale`` finds one, else None; the port's plain version
    (``add_residual``'s ``inv_out_scale``) equals the JAX kernel given
    the same ``inv_out``."""
    inv = exact_inv_out_scale(*scales)
    assert (inv is None) == (scales == NO_PROOF)
    assert ops.exact_inv_out_scale(*scales) == inv
    c = _case(cin + w, 128, cin, cout, h, w)
    got = _port(c, scales, inv_out=inv)
    np.testing.assert_array_equal(got.numpy(), _jax(c, scales, inv=inv))
    np.testing.assert_array_equal(got.numpy(), _port(c, scales).numpy())


def test_no_proof_triple_needs_the_divide():
    """At ``NO_PROOF`` the rounded reciprocal, and its two 1-ulp
    neighbours, each requantize some int8 pair of the join otherwise than
    the divide, before the join's ReLU, where the proof (the JAX one too)
    compares them: no reciprocal is proven, so the kernel's divide join
    must stay."""
    z, r = np.meshgrid(np.arange(-128, 128), np.arange(-128, 128))
    z = torch.from_numpy(z.astype(np.int8))
    r = torch.from_numpy(r.astype(np.int8))
    want = ops.add_residual(z, r, *NO_PROOF)
    inv0 = np.float32(1) / np.float32(NO_PROOF[2])
    for inv in (inv0, np.nextafter(inv0, np.float32(0)),
                np.nextafter(inv0, np.float32(np.inf))):
        got = ops.add_residual(z, r, *NO_PROOF, inv_out_scale=float(inv))
        assert not torch.equal(got, want)


@pytest.mark.parametrize("n,cin,cout,h,w", [
    (2, 64, 256, 7, 7), (1, 12, 20, 1, 1), (3, 8, 36, 5, 3)])
def test_wrapper_equals_conv_then_join(n, cin, cout, h, w):
    """On CPU tensors the wrapper runs the plain version, which is K2's
    function at kernel 1 without ReLU followed by the residual join."""
    c = _case(n + cin, n, cin, cout, h, w)
    scales = (0.0213, 0.0172, 0.0311)
    got = _port(c, scales, fn=ops.expand_add_int8)
    assert torch.equal(got, _port(c, scales, fn=ops.expand_add_int8,
                                  inv_out=exact_inv_out_scale(*scales)))
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    y = ops.conv2d_int8_plain(t["x"], t["w"].reshape(cout, cin, 1, 1),
                              t["b"], t["f"], relu=False)
    want = ops.add_residual(y, t["r"], *scales, relu=True)
    assert torch.equal(got, want)
    assert torch.equal(got, ops.conv2d_int8_plain(
        t["x"], t["w"].reshape(cout, cin, 1, 1), t["b"], t["f"],
        residual=t["r"], res_scales=scales))

