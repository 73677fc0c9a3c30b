"""PyTorch port: ``SparseProjection.from_fixture_dir`` and
``SparseAttentionInt8`` (``models/attention.py``) and the gather pack
``device_pack_gather`` (``ops/bsr_matmul.py``) against the JAX package's.

The fixtures come from one ``generate_all_fixtures`` in this process (its
transformer weights are seeded with the per-process ``str`` hash), read by
both packages.  The attention runs on the CPU here, within rtol 2e-4, atol
2e-5 of JAX's ``__call__`` and of the golden (``tests/test_attention.py``'s
tolerance: float32 softmax and products summed in another order); the
projections and the gather pack's products are int32, equal.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resnet_accel_tpu import golden as jgolden
from resnet_accel_tpu.models import attention as jatt
from resnet_accel_tpu.ops.bsr_matmul import bsr_matmul_wt_xla as jxla
from resnet_accel_tpu.ops.bsr_matmul import pack_gather_bsr as jpack_gather
from resnet_accel_tpu.sparse import build_bsr_int8_direct as jbuild
from resnet_accel_tpu.sparse.device_pack import device_pack_gather as jdpg
from resnet_accel_tpu.sparse.fixtures import generate_all_fixtures
from resnet_accel_tpu_torch import ops
from resnet_accel_tpu_torch.models.attention import (SparseAttentionInt8,
                                                     SparseProjection)
from resnet_accel_tpu_torch.sparse import build_bsr_int8_direct

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("fx")
    generate_all_fixtures(str(root), seed=0)
    return str(root)


@pytest.mark.parametrize("sp", ["80pct", "90pct"])
@pytest.mark.parametrize("mat", ["q", "k", "v"])
def test_projection_from_fixture_dir(fixture_root, sp, mat):
    path = os.path.join(fixture_root, "transformer", sp, mat)
    mine = SparseProjection.from_fixture_dir(path)
    theirs = jatt.SparseProjection.from_fixture_dir(path)
    for f in ("data", "row_ptr", "col_idx"):
        assert np.array_equal(getattr(mine.bsr, f), getattr(theirs.bsr, f))
    assert np.array_equal(mine.scales, theirs.scales)
    assert np.array_equal(mine.bias, theirs.bias)
    assert (mine.d_in, mine.d_out) == (theirs.d_in, theirs.d_out) == (128, 64)
    x = np.random.default_rng(0).integers(-128, 128, (16, 128)).astype(
        np.int8)
    want = theirs.project_golden(x, 0.01)
    assert np.array_equal(mine.project_golden(x, 0.01), want)
    packed = mine.to("cpu")
    got = packed.project(torch.from_numpy(x), torch.tensor(0.01))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_projection_needs_scales(fixture_root, tmp_path):
    src = os.path.join(fixture_root, "transformer", "80pct", "q")
    for f in ("weights.bsr", "row_ptr.npy", "col_idx.npy",
              "weights.meta.json"):
        with open(os.path.join(src, f), "rb") as a, \
                open(tmp_path / f, "wb") as b:
            b.write(a.read())
    with pytest.raises(ValueError, match="scales.npy"):
        SparseProjection.from_fixture_dir(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="missing projection dir"):
        SparseAttentionInt8.from_fixture_root(str(tmp_path), device="cpu")


@pytest.mark.parametrize("sp", ["80pct", "90pct"])
def test_sparsity_report(fixture_root, sp):
    root = os.path.join(fixture_root, "transformer", sp)
    got = SparseAttentionInt8.from_fixture_root(root, device="cpu")
    want = jatt.SparseAttentionInt8.from_fixture_root(root)
    assert got.sparsity_report() == want.sparsity_report()
    lo = 0.75 if sp == "80pct" else 0.85
    assert all(lo < v < lo + 0.1 for v in got.sparsity_report().values())


@pytest.mark.parametrize("sp", ["80pct", "90pct"])
@pytest.mark.parametrize("T", [1, 8, 33])
def test_attention_against_jax_and_golden(fixture_root, sp, T):
    root = os.path.join(fixture_root, "transformer", sp)
    mine = SparseAttentionInt8.from_fixture_root(root, device="cpu")
    theirs = jatt.SparseAttentionInt8.from_fixture_root(root)
    x = np.random.default_rng(T).normal(0, 1, (T, 128)).astype(np.float32)
    got = mine(x)
    assert got.device.type == "cpu" and got.dtype == torch.float32
    assert tuple(got.shape) == (T, 64)
    got = got.numpy()
    np.testing.assert_allclose(got, np.asarray(theirs(jnp.asarray(x))),
                               rtol=2e-4, atol=2e-5)
    gold = mine.forward_golden(x)
    assert np.array_equal(gold, theirs.forward_golden(x))
    np.testing.assert_allclose(got, gold, rtol=2e-4, atol=2e-5)
    # a tensor input gives the same output
    assert torch.equal(mine(torch.from_numpy(x)), torch.from_numpy(got))


def test_attention_is_a_convex_combination_of_v(fixture_root):
    att = SparseAttentionInt8.from_fixture_root(
        os.path.join(fixture_root, "transformer", "80pct"), device="cpu")
    x = np.random.default_rng(2).normal(0, 1, (4, 128)).astype(np.float32)
    x_scale = max(float(np.abs(x).max()) / 127.0, 1e-12)
    xq = np.clip(np.rint(x / x_scale), -128, 127).astype(np.int8)
    v = att.v.project_golden(xq, x_scale)
    out = att(x).numpy()
    assert out.min() >= v.min() - 1e-4 and out.max() <= v.max() + 1e-4


def test_attention_on_cuda_without_card_raises(fixture_root):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        SparseAttentionInt8.from_fixture_root(
            os.path.join(fixture_root, "transformer", "80pct"))


# ---- device_pack_gather: every case of tests/test_device_pack.py ---------

def sparse_w(rng, n, k, b, sp):
    W = rng.integers(-128, 128, (n, k)).astype(np.int8)
    for br in range(-(-n // b)):
        for bc in range(-(-k // b)):
            if rng.random() < sp:
                W[br * b:(br + 1) * b, bc * b:(bc + 1) * b] = 0
    return W


def _both(W, b, **kw):
    """The port's and JAX's gather packs of W, their packed arrays equal."""
    mine = ops.device_pack_gather(torch.from_numpy(W), b, **kw)
    theirs = jdpg(jnp.asarray(W), b, **kw)
    assert mine.lmax == theirs.lmax
    assert np.array_equal(mine.blocks.numpy(), np.asarray(theirs.blocks))
    assert np.array_equal(mine.gather_idx.numpy(),
                          np.asarray(theirs.gather_idx))
    for f in ("block_h", "block_w", "n_out", "k_dim", "n_padded",
              "k_padded"):
        assert getattr(mine, f) == getattr(theirs, f), f
    return mine, theirs


def _product(A, mine, theirs):
    got = ops.bsr_matmul_wt_xla(torch.from_numpy(A), mine).numpy()
    assert np.array_equal(got, np.asarray(jxla(jnp.asarray(A), theirs)))
    return got


@pytest.mark.parametrize("sp", [0.0, 0.6, 0.95])
def test_device_pack_matmul_matches_host_pack(sp):
    rng = np.random.default_rng(0)
    W = sparse_w(rng, 256, 384, 128, sp)
    A = rng.integers(-128, 128, (8, 384)).astype(np.int8)
    got = _product(A, *_both(W, 128))
    np.testing.assert_array_equal(got, jgolden.matmul_int8(A, W.T))


def test_device_pack_matches_host_gather_pack_blocks():
    rng = np.random.default_rng(1)
    W = sparse_w(rng, 128, 256, 64, 0.5)
    mine, theirs = _both(W, 64)
    host = ops.pack_gather_bsr(build_bsr_int8_direct(W, 64), "cpu")
    assert mine.block_h == host.block_h == jpack_gather(
        jbuild(W, 64)).block_h
    A = rng.integers(-128, 128, (4, 256)).astype(np.int8)
    a = _product(A, mine, theirs)
    b = ops.bsr_matmul_wt_xla(torch.from_numpy(A), host).numpy()
    np.testing.assert_array_equal(a, b)


def test_device_pack_lmax_bound():
    rng = np.random.default_rng(2)
    W = sparse_w(rng, 128, 512, 128, 0.75)
    A = rng.integers(-128, 128, (2, 512)).astype(np.int8)
    got = _product(A, *_both(W, 128, lmax=4))
    np.testing.assert_array_equal(got, jgolden.matmul_int8(A, W.T))


def test_device_pack_lmax_too_small_raises():
    W = np.ones((128, 512), np.int8)  # dense: 4 blocks per row
    with pytest.raises(ValueError, match="lmax=2 too small"):
        ops.device_pack_gather(torch.from_numpy(W), 128, lmax=2)
    with pytest.raises(ValueError):
        jdpg(jnp.asarray(W), 128, lmax=2)


def test_device_pack_ragged_shape():
    rng = np.random.default_rng(3)
    W = sparse_w(rng, 100, 300, 64, 0.4)
    A = rng.integers(-128, 128, (3, 300)).astype(np.int8)
    got = _product(A, *_both(W, 64))
    np.testing.assert_array_equal(got, jgolden.matmul_int8(A, W.T))


def test_device_pack_dtype_check():
    with pytest.raises(ValueError, match="int8"):
        ops.device_pack_gather(torch.ones((64, 64), dtype=torch.float32), 64)


def test_device_pack_at_14x14_blocks():
    """The reference's 14 x 14 blocks on a ragged FC1-like weight, against
    the host pack of the same weight."""
    rng = np.random.default_rng(4)
    W = sparse_w(rng, 128, 1000, 14, 0.9)
    A = rng.integers(-128, 128, (5, 1000)).astype(np.int8)
    got = _product(A, *_both(W, 14))
    host = ops.pack_gather_bsr(build_bsr_int8_direct(W, 14), "cpu")
    np.testing.assert_array_equal(
        got, ops.bsr_matmul_wt_xla(torch.from_numpy(A), host).numpy())


def test_device_pack_name_still_k8s_packer():
    """The gather pack lives in ``ops.bsr_matmul``: the sparse package's
    ``device_pack`` (K8's packer) keeps its name after both are imported."""
    import resnet_accel_tpu_torch.ops.bsr_matmul as bm
    import resnet_accel_tpu_torch.sparse as sparse
    from resnet_accel_tpu_torch.sparse import conv_bsr, device_pack
    assert device_pack is conv_bsr.device_pack is sparse.device_pack
    assert callable(device_pack) and device_pack.__module__ == conv_bsr.__name__
    assert bm.device_pack_gather is ops.device_pack_gather
