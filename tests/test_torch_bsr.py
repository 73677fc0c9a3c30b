"""PyTorch port: the BSR container and the zero-skip GEMM (kernel K4's
wrapper) against the JAX package, bit for bit (tolerance 0).

On the CPU ``bsr_matmul_wt`` runs its plain version, which must equal the
JAX ``bsr_matmul_wt`` (its Pallas kernel in interpret mode, as
tests/test_bsr_matmul.py runs it) and the numpy golden
``bsr_matmul_int8_wt``.  The kernel itself runs only on a card:
tests/test_torch_kernels.py holds it against the plain version there.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from resnet_accel_tpu import config as jconfig
from resnet_accel_tpu import golden
from resnet_accel_tpu.ops import requant_factors
from resnet_accel_tpu.ops.bsr_matmul import bsr_matmul_wt as j_bsr_matmul_wt
from resnet_accel_tpu.ops.bsr_matmul import pack_kernel_bsr
from resnet_accel_tpu.sparse import bsr as jbsr
from resnet_accel_tpu_torch import ops
from resnet_accel_tpu_torch.sparse import bsr as pbsr

torch.set_num_threads(2)


def sparse_weight(rng, n, k, bh, bw, sparsity):
    """int8 [n, k] with each bh x bw tile zeroed with probability
    ``sparsity`` (the helper of tests/test_bsr_matmul.py)."""
    W = rng.integers(-128, 128, (n, k)).astype(np.int8)
    for br in range(-(-n // bh)):
        for bc in range(-(-k // bw)):
            if rng.random() < sparsity:
                W[br * bh:(br + 1) * bh, bc * bw:(bc + 1) * bw] = 0
    return W


def _assert_same_bsr(got, want):
    for f in ("data", "row_ptr", "col_idx"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for p in ("shape", "block_h", "block_w", "nnz_blocks", "padded_shape",
              "num_block_rows", "num_block_cols", "total_blocks", "density",
              "sparsity_pct"):
        assert getattr(got, p) == getattr(want, p), p
    np.testing.assert_array_equal(got.tiles_per_row, want.tiles_per_row)
    assert got.compression_ratio() == want.compression_ratio()
    for padded in (False, True):
        np.testing.assert_array_equal(got.to_dense(padded),
                                      want.to_dense(padded))


# ------------------------------------------------------------ containers

class TestBSRMatrix:
    def test_config_copies(self):
        assert pbsr.REF_BLOCK == jconfig.REF_BLOCK
        for x, m in [(0, 14), (1, 14), (14, 14), (300, 128), (9216, 128)]:
            assert pbsr.round_up(x, m) == jconfig.round_up(x, m)

    @pytest.mark.parametrize("bh,bw,sparsity", [
        (128, 128, 0.5), (64, 32, 0.9), (14, 14, 0.7), (32, 64, 0.0),
        (128, 128, 1.0)])
    def test_build_int8_direct_identical(self, bh, bw, sparsity):
        rng = np.random.default_rng(bh + bw)
        W = sparse_weight(rng, 200, 300, bh, bw, sparsity)
        got = pbsr.build_bsr_int8_direct(W, bh, bw)
        want = jbsr.build_bsr_int8_direct(W, bh, bw)
        _assert_same_bsr(got, want)
        got.validate()
        np.testing.assert_array_equal(got.to_dense(), W)

    def test_build_bsr_quantize_identical(self):
        rng = np.random.default_rng(1)
        W = rng.normal(0, 0.1, (30, 40)).astype(np.float32)
        W[:14, 14:28] = 0.0
        scales = rng.uniform(1e-3, 2e-3, 25).astype(np.float32)
        got = pbsr.build_bsr(W, 14, quantize=True, scales=scales)
        want = jbsr.build_bsr(W, 14, quantize=True, scales=scales)
        _assert_same_bsr(got, want)
        _assert_same_bsr(pbsr.build_bsr(W, 14, 7, threshold=0.05),
                         jbsr.build_bsr(W, 14, 7, threshold=0.05))
        with pytest.raises(ValueError):
            pbsr.build_bsr(W, 14, quantize=True)

    @pytest.mark.parametrize("field,value", [
        ("row_ptr", np.array([1, 2, 3], np.int32)),
        ("row_ptr", np.array([0, 3, 2], np.int32)),
        ("col_idx", np.array([0, 5], np.int32)),
        ("col_idx", np.array([1, 0], np.int32))])
    def test_validate_raises_as_the_reference(self, field, value):
        W = np.ones((28, 28), np.int8)
        W[14:, :] = 0
        W[:14, :] = 1
        base = pbsr.build_bsr_int8_direct(W, 14)   # row_ptr [0, 2, 2]
        bad = dataclasses.replace(base, **{field: value})
        ref = jbsr.BSRMatrix(**{f.name: getattr(bad, f.name)
                                for f in dataclasses.fields(bad)})
        with pytest.raises(ValueError):
            ref.validate()
        with pytest.raises(ValueError):
            bad.validate()


class TestPack:
    @pytest.mark.parametrize("block", [128, 64, 32, 14])
    def test_pack_keeps_the_csr(self, block):
        rng = np.random.default_rng(block)
        W = sparse_weight(rng, 200, 300, block, block, 0.5)
        bsr = pbsr.build_bsr_int8_direct(W, block)
        packed = ops.pack_bsr(bsr, "cpu")
        assert packed.blocks.dtype == torch.int8
        np.testing.assert_array_equal(packed.blocks.numpy(), bsr.data)
        assert packed.row_ptr.dtype == packed.col_idx.dtype == torch.int32
        np.testing.assert_array_equal(packed.row_ptr.numpy(), bsr.row_ptr)
        np.testing.assert_array_equal(packed.col_idx.numpy(), bsr.col_idx)
        kb = pack_kernel_bsr(jbsr.build_bsr_int8_direct(W, block))
        for f in ("block_h", "block_w", "n_out", "k_dim", "n_padded",
                  "k_padded", "nnz_source", "total_source"):
            assert getattr(packed, f) == getattr(kb, f), f


# ------------------------------------------------------------------ GEMM

def _golden(A, bsr, N, bias=None, f=None, relu=False):
    acc = golden.bsr_matmul_int8_wt(A, bsr.data, bsr.row_ptr, bsr.col_idx,
                                    bsr.block_h, bsr.block_w, N=N)
    acc = acc.astype(np.int64)
    if bias is not None:
        acc = acc + bias[None, :]
    if relu:
        acc = np.maximum(acc, 0)
    acc = acc.astype(np.int32)
    if f is None:
        return acc
    return np.clip(np.rint(acc.astype(np.float32) * f[None, :]),
                   -128, 127).astype(np.int8)


def _epilogue_args(rng, N, requant):
    if not requant:
        return None, None
    bias = rng.integers(-3000, 3000, N).astype(np.int32)
    f = requant_factors(0.02, rng.uniform(0.001, 0.01, N), 0.07)
    return bias, f


def _three_ways(A, W, bh, bw, bias, f):
    """(port, JAX, golden) outputs of A @ W^T with the optional epilogue."""
    N = W.shape[0]
    relu = f is not None
    bsr = pbsr.build_bsr_int8_direct(W, bh, bw)
    got = ops.bsr_matmul_wt(
        torch.from_numpy(A), ops.pack_bsr(bsr, "cpu"),
        bias=None if bias is None else torch.from_numpy(bias),
        factors=None if f is None else torch.from_numpy(f), relu=relu)
    kb = pack_kernel_bsr(jbsr.build_bsr_int8_direct(W, bh, bw))
    jax_out = j_bsr_matmul_wt(
        jnp.asarray(A), kb, bias=None if bias is None else jnp.asarray(bias),
        factors=f, relu=relu)
    return got.numpy(), np.asarray(jax_out), _golden(A, bsr, N, bias, f,
                                                      relu)


class TestBsrMatmul:
    @pytest.mark.parametrize("requant", [False, True])
    @pytest.mark.parametrize("block", [128, 64, 32])
    @pytest.mark.parametrize("sparsity", [0.0, 0.5, 0.9])
    def test_bit_exact_vs_jax_and_golden(self, sparsity, block, requant):
        rng = np.random.default_rng(int(sparsity * 10) + block)
        N, K, M = 256, 512, 64
        W = sparse_weight(rng, N, K, block, block, sparsity)
        A = rng.integers(-128, 128, (M, K)).astype(np.int8)
        bias, f = _epilogue_args(rng, N, requant)
        got, jax_out, gold = _three_ways(A, W, block, block, bias, f)
        assert got.dtype == gold.dtype == (np.int8 if requant else np.int32)
        np.testing.assert_array_equal(got, gold)
        np.testing.assert_array_equal(jax_out, gold)

    @pytest.mark.parametrize("requant", [False, True])
    def test_empty_block_row(self, requant):
        rng = np.random.default_rng(1)
        N, K, M = 384, 256, 32
        W = sparse_weight(rng, N, K, 128, 128, 0.0)
        W[128:256] = 0  # the middle block row stores no block
        A = rng.integers(-128, 128, (M, K)).astype(np.int8)
        bias, f = _epilogue_args(rng, N, requant)
        got, jax_out, gold = _three_ways(A, W, 128, 128, bias, f)
        np.testing.assert_array_equal(got, gold)
        np.testing.assert_array_equal(jax_out, gold)
        if requant:
            empty = np.clip(np.rint(np.maximum(bias[128:256], 0).astype(
                np.float32) * f[128:256]), -128, 127)
            np.testing.assert_array_equal(got[:, 128:256],
                                          np.broadcast_to(empty, (M, 128)))
        else:
            assert np.all(got[:, 128:256] == 0)

    @pytest.mark.parametrize("block", [128, 32])
    @pytest.mark.parametrize("padded_k", [False, True])
    def test_unaligned_m_n_k(self, block, padded_k):
        rng = np.random.default_rng(3 + block)
        N, K, M = 200, 300, 17
        W = sparse_weight(rng, N, K, block, block, 0.25)
        A = rng.integers(-128, 128, (M, K)).astype(np.int8)
        bias, f = _epilogue_args(rng, N, True)
        bsr = pbsr.build_bsr_int8_direct(W, block)
        a = torch.from_numpy(A)
        if padded_k:   # zero columns up to the block grid's K
            a = torch.nn.functional.pad(a, (0, bsr.padded_shape[1] - K))
        got = ops.bsr_matmul_wt(a, ops.pack_bsr(bsr, "cpu"),
                                bias=torch.from_numpy(bias),
                                factors=torch.from_numpy(f), relu=True)
        np.testing.assert_array_equal(got.numpy(),
                                      _golden(A, bsr, N, bias, f, True))

    def test_k_mismatch_raises(self):
        W = np.ones((128, 256), np.int8)
        packed = ops.pack_bsr(pbsr.build_bsr_int8_direct(W, 128), "cpu")
        kb = pack_kernel_bsr(jbsr.build_bsr_int8_direct(W, 128))
        with pytest.raises(ValueError):
            j_bsr_matmul_wt(jnp.zeros((4, 999), jnp.int8), kb)
        with pytest.raises(ValueError, match="K=999"):
            ops.bsr_matmul_wt(torch.zeros((4, 999), dtype=torch.int8),
                              packed)
        with pytest.raises(ValueError, match="K=999"):
            ops.bsr_matmul_wt_plain(torch.zeros((4, 999), dtype=torch.int8),
                                    packed)

    @pytest.mark.parametrize("sparsity", [0.0, 0.7, 0.95])
    def test_14x14_blocks_plain_vs_golden(self, sparsity):
        """The reference's own block size, through the plain version (the
        kernel's small-block path is held to it on a card, and modelled on
        the CPU in tests/test_torch_bsr_small.py)."""
        rng = np.random.default_rng(5)
        W = sparse_weight(rng, 70, 126, 14, 14, sparsity)
        A = rng.integers(-128, 128, (5, 126)).astype(np.int8)
        bsr = pbsr.build_bsr_int8_direct(W, 14)
        bias, f = _epilogue_args(rng, 70, True)
        packed = ops.pack_bsr(bsr, "cpu")
        got = ops.bsr_matmul_wt_plain(torch.from_numpy(A), packed)
        np.testing.assert_array_equal(got.numpy(), _golden(A, bsr, 70))
        np.testing.assert_array_equal(got.numpy(), golden.matmul_int8(A, W.T))
        got = ops.bsr_matmul_wt_plain(
            torch.from_numpy(A), packed, bias=torch.from_numpy(bias),
            factors=torch.from_numpy(f), relu=True)
        np.testing.assert_array_equal(got.numpy(),
                                      _golden(A, bsr, 70, bias, f, True))
