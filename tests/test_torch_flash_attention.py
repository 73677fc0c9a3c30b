"""PyTorch port: attention (K5's function) against the JAX package's flash
attention kernel, run on the CPU as its own tests run it (interpret mode),
and against a float64 reference.

On the CPU ``flash_attention`` runs its plain version; the kernel itself is
held against that plain version on the card (tests/test_torch_kernels.py).
Tolerance: rtol = atol = 2e-5, the tolerance the JAX kernel is held to in
tests/test_flash_attention.py (float32 softmax over up to 512 keys, summed
in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from resnet_accel_tpu.ops.flash_attention import (
    flash_attention as j_flash_attention)
from resnet_accel_tpu_torch import _kernels
from resnet_accel_tpu_torch.ops import flash_attention, flash_attention_plain

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)


def reference(q, k, v, causal, scale=None):
    """Materialised softmax in float64 (tests/test_flash_attention.py)."""
    H, T, dh = q.shape
    if scale is None:
        scale = 1.0 / np.sqrt(dh)
    s = np.einsum("htd,hsd->hts", q, k).astype(np.float64) * scale
    if causal:
        mask = np.tril(np.ones((T, T), bool))
        s = np.where(mask[None], s, -np.inf)
    e = np.exp(s - s.max(axis=-1, keepdims=True))
    a = e / e.sum(axis=-1, keepdims=True)
    return np.einsum("hts,hsd->htd", a, v).astype(np.float32)


def rand_qkv(rng, h, t, dh):
    return tuple(rng.normal(0, 1, (h, t, dh)).astype(np.float32)
                 for _ in range(3))


def port(q, k, v, **kw):
    return flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                           **kw).numpy()


def jax_fa(q, k, v, **kw):
    return np.asarray(j_flash_attention(
        *(jnp.asarray(a) for a in (q, k, v)), **kw))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [128, 256])
def test_matches_jax(causal, t):
    q, k, v = rand_qkv(np.random.default_rng(0), 2, t, 128)
    got = port(q, k, v, causal=causal)
    np.testing.assert_allclose(got, jax_fa(q, k, v, causal=causal), **TOL)
    np.testing.assert_allclose(got, reference(q, k, v, causal), **TOL)


@pytest.mark.parametrize("t", [100, 130])
def test_ragged_t(t):
    q, k, v = rand_qkv(np.random.default_rng(1), 1, t, 64)
    got = port(q, k, v, causal=True)
    assert got.shape == (1, t, 64)
    np.testing.assert_allclose(got, jax_fa(q, k, v, causal=True), **TOL)
    np.testing.assert_allclose(got, reference(q, k, v, True), **TOL)


def test_many_key_blocks():
    """T = 512 with the JAX kernel's blocks at 128, so that it carries its
    (m, l, acc) across four key blocks."""
    q, k, v = rand_qkv(np.random.default_rng(2), 1, 512, 64)
    got = port(q, k, v)
    np.testing.assert_allclose(
        got, jax_fa(q, k, v, block_q=128, block_k=128), **TOL)
    np.testing.assert_allclose(got, reference(q, k, v, False), **TOL)


def test_custom_scale():
    q, k, v = rand_qkv(np.random.default_rng(3), 1, 128, 64)
    got = port(q, k, v, scale=0.5)
    np.testing.assert_allclose(got, jax_fa(q, k, v, scale=0.5), **TOL)
    np.testing.assert_allclose(got, reference(q, k, v, False, scale=0.5),
                               **TOL)


def test_default_scale_is_inverse_sqrt_dh():
    q, k, v = (torch.from_numpy(a) for a in
               rand_qkv(np.random.default_rng(4), 2, 40, 16))
    assert torch.equal(flash_attention(q, k, v, causal=True),
                       flash_attention_plain(q, k, v, causal=True,
                                             scale=0.25))


def test_shape_mismatch_raises():
    q = torch.zeros((1, 8, 16))
    with pytest.raises(ValueError, match="shape mismatch"):
        flash_attention(q, torch.zeros((1, 9, 16)), q)
    with pytest.raises(ValueError, match="shape mismatch"):
        flash_attention_plain(q, q, torch.zeros((1, 8, 17)))


def test_cpu_runs_the_plain_version_and_counts_no_launch():
    q, k, v = (torch.from_numpy(a) for a in
               rand_qkv(np.random.default_rng(5), 3, 70, 32))
    before = _kernels.launch_counts()["flash_attention"]
    got = flash_attention(q, k, v, causal=True)
    assert torch.equal(got, flash_attention_plain(q, k, v, causal=True))
    assert _kernels.launch_counts()["flash_attention"] == before
