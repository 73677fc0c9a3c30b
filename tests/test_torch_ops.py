"""PyTorch port: each op with a kernel (K1 stem, K2 conv, K3 GEMM) and the
epilogues and pools, against the JAX functions on the same numpy inputs.

On the CPU the port's wrappers run their plain PyTorch versions; those
must equal the JAX functions bit for bit (tolerance 0).  The kernels
themselves run only on a card: tests/test_torch_kernels.py holds each
kernel against its plain version there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from resnet_accel_tpu.ops import conv as jconv
from resnet_accel_tpu.ops import epilogue as jepi
from resnet_accel_tpu.ops import pooling as jpool
from resnet_accel_tpu.ops.matmul_int8 import matmul_int8 as j_matmul_int8
from resnet_accel_tpu.ops.stem_fused import stem_conv_pool_nm
from resnet_accel_tpu_torch import _kernels
from resnet_accel_tpu_torch import ops
from resnet_accel_tpu_torch.sparse import (build_bsr_int8_direct,
                                           device_pack, pack_conv_bsr)

torch.set_num_threads(2)


def _i8(rng, shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


def _t(a, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


# --------------------------------------------------------------- epilogue

class TestEpilogue:
    @pytest.mark.parametrize("relu", [False, True])
    def test_requantize(self, relu):
        rng = np.random.default_rng(0)
        acc = rng.integers(-2 ** 20, 2 ** 20, (6, 40)).astype(np.int32)
        bias = rng.integers(-5000, 5000, 40).astype(np.int32)
        f = rng.uniform(1e-5, 1e-3, 40).astype(np.float32)
        want = np.asarray(jepi.requantize(jnp.asarray(acc), jnp.asarray(f),
                                          relu=relu, bias=jnp.asarray(bias)))
        got = ops.requantize(_t(acc), _t(f), relu=relu, bias=_t(bias))
        np.testing.assert_array_equal(got.numpy(), want)

    def test_requantize_ties_round_half_even(self):
        acc = np.array([1, 3, 5, -1, -3, 7], np.int32)
        f = np.float32(0.5)
        want = np.asarray(jepi.requantize(jnp.asarray(acc), f))
        got = ops.requantize(_t(acc), torch.tensor(0.5))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(want, [0, 2, 2, 0, -2, 4])

    def test_requant_factors(self):
        w_s = np.random.default_rng(1).uniform(1e-4, 1e-2, 64)
        np.testing.assert_array_equal(
            ops.requant_factors(0.0371, w_s, 0.113),
            jepi.requant_factors(0.0371, w_s, 0.113))

    @pytest.mark.parametrize("scales", [(0.02, 0.03, 0.05),
                                        (0.0173, 0.0091, 0.0217),
                                        (0.5, 0.25, 0.125)])
    def test_exact_inv_out_scale(self, scales):
        assert (ops.exact_inv_out_scale(*scales)
                == jepi.exact_inv_out_scale(*scales))

    @pytest.mark.parametrize("proof", [False, True])
    def test_add_residual(self, proof):
        rng = np.random.default_rng(2)
        m, r = _i8(rng, (4, 8, 5, 5)), _i8(rng, (4, 8, 5, 5))
        sc = (0.0213, 0.0172, 0.0311)
        inv = jepi.exact_inv_out_scale(*sc) if proof else None
        if proof:
            assert inv is not None
        want = np.asarray(jepi.add_residual(
            jnp.asarray(m), jnp.asarray(r), *sc, relu=True,
            inv_out_scale=inv))
        got = ops.add_residual(_t(m), _t(r), *sc, relu=True,
                               inv_out_scale=inv)
        np.testing.assert_array_equal(got.numpy(), want)

    def test_quantize_input(self):
        rng = np.random.default_rng(3)
        x = rng.normal(0, 2, (2, 3, 9, 9)).astype(np.float32)
        s = float(np.abs(x).max() / 127.0) * 0.7      # some saturate
        want = np.asarray(jepi.quantize_input(jnp.asarray(x), s))
        np.testing.assert_array_equal(
            ops.quantize_input(_t(x), s).numpy(), want)


# ---------------------------------------------------------------- pooling

class TestPooling:
    @pytest.mark.parametrize("k,s,p", [(3, 2, 1), (2, 2, 0), (3, 1, 1)])
    def test_maxpool(self, k, s, p):
        x = _i8(np.random.default_rng(4), (2, 5, 11, 9))
        want = np.asarray(jpool.maxpool2d_int8(jnp.asarray(x), k, s, p))
        np.testing.assert_array_equal(
            ops.maxpool2d_int8(_t(x), k, s, p).numpy(), want)

    @pytest.mark.parametrize("hw", [(7, 7), (3, 5)])
    def test_avgpool_truncates_like_c(self, hw):
        # skewed negative so sums are negative: trunc differs from floor
        rng = np.random.default_rng(5)
        x = rng.integers(-128, 60, (3, 16) + hw).astype(np.int8)
        want = np.asarray(jpool.avgpool_global_int8(jnp.asarray(x)))
        np.testing.assert_array_equal(
            ops.avgpool_global_int8(_t(x)).numpy(), want)


# ---------------------------------------------------------------- K3 GEMM

class TestMatmulPlain:
    @pytest.mark.parametrize("M,K,N", [(5, 37, 19), (33, 300, 130),
                                       (128, 512, 1000)])
    @pytest.mark.parametrize("requant,relu", [(False, False),
                                              (False, True),
                                              (True, False), (True, True)])
    def test_vs_jax(self, M, K, N, requant, relu):
        rng = np.random.default_rng(M + K + N)
        a, b = _i8(rng, (M, K)), _i8(rng, (K, N))
        bias = rng.integers(-20000, 20000, N).astype(np.int32)
        f = (rng.uniform(1e-5, 1e-3, N).astype(np.float32) if requant
             else None)
        want = np.asarray(j_matmul_int8(
            jnp.asarray(a), jnp.asarray(b), bias=jnp.asarray(bias),
            factors=None if f is None else jnp.asarray(f), relu=relu,
            use_pallas=True))
        got = ops.matmul_int8(_t(a), _t(b), bias=_t(bias),
                              factors=None if f is None else _t(f),
                              relu=relu)
        assert got.dtype == (torch.int8 if requant else torch.int32)
        np.testing.assert_array_equal(got.numpy(), want)

    def test_shape_mismatch_raises(self):
        with pytest.raises(ValueError, match="shape mismatch"):
            ops.matmul_int8(torch.zeros(2, 3, dtype=torch.int8),
                            torch.zeros(4, 5, dtype=torch.int8))


# ---------------------------------------------------------------- K2 conv

def _conv_case(seed, N, C, O, H, k):
    rng = np.random.default_rng(seed)
    x = _i8(rng, (N, C, H, H))
    w2d = _i8(rng, (O, C * k * k))
    bias = rng.integers(-3000, 3000, O).astype(np.int32)
    f = rng.uniform(1e-4, 2e-3, O).astype(np.float32)
    return rng, x, w2d, bias, f


class TestConvPlain:
    @pytest.mark.parametrize("k,stride", [(1, 1), (1, 2), (3, 1), (3, 2)])
    @pytest.mark.parametrize("relu", [False, True])
    def test_vs_jax(self, k, stride, relu):
        _, x, w2d, bias, f = _conv_case(10 + k + stride, 2, 8, 12, 9, k)
        pad = k // 2
        want = np.asarray(jconv.conv2d_int8(
            jnp.asarray(x), jnp.asarray(w2d), jnp.asarray(bias), kernel=k,
            stride=stride, padding=pad, factors=jnp.asarray(f), relu=relu,
            method="native"))
        w = ops.pack_weight(w2d, 8, k, torch.device("cpu"))
        got = ops.conv2d_int8(_t(x), w, _t(bias), _t(f), stride=stride,
                              padding=pad, relu=relu)
        np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (1, 2)])
    def test_residual_join_vs_jax(self, k, stride):
        rng, x, w2d, bias, f = _conv_case(20 + k + stride, 2, 8, 8, 10, k)
        pad = k // 2
        y = np.asarray(jconv.conv2d_int8(
            jnp.asarray(x), jnp.asarray(w2d), jnp.asarray(bias), kernel=k,
            stride=stride, padding=pad, factors=jnp.asarray(f),
            method="native"))
        r = _i8(rng, y.shape)
        sc = (0.0213, 0.0172, 0.0311)
        want = np.asarray(jepi.add_residual(jnp.asarray(y), jnp.asarray(r),
                                            *sc, relu=True))
        w = ops.pack_weight(w2d, 8, k, torch.device("cpu"))
        got = ops.conv2d_int8(_t(x), w, _t(bias), _t(f), stride=stride,
                              padding=pad, residual=_t(r), res_scales=sc)
        np.testing.assert_array_equal(got.numpy(), want)

    def test_im2col_vs_jax(self):
        x = _i8(np.random.default_rng(6), (2, 3, 7, 6))
        want = np.asarray(jconv.im2col_nchw(jnp.asarray(x), 3, 2, 1))
        np.testing.assert_array_equal(
            ops.im2col_nchw(_t(x), 3, 2, 1).numpy(), want)

    def test_pack_weight_is_channels_last_oihw(self):
        w2d = np.arange(4 * 8 * 9).reshape(4, 72).astype(np.int8)
        w = ops.pack_weight(w2d, 8, 3, torch.device("cpu"))
        assert w.shape == (4, 8, 3, 3)
        assert w.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_array_equal(w.reshape(4, -1).numpy(), w2d)

    def test_residual_needs_scales(self):
        _, x, w2d, bias, f = _conv_case(0, 1, 4, 4, 5, 3)
        w = ops.pack_weight(w2d, 4, 3, torch.device("cpu"))
        with pytest.raises(ValueError, match="together"):
            ops.conv2d_int8(_t(x), w, _t(bias), _t(f), padding=1,
                            residual=_t(x))


# ---------------------------------------------------------------- K1 stem

def _stem_case(N, H, W, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (N, 3, H, W)).astype(np.float32)
    w = _i8(rng, (64, 3 * 49))
    bias = rng.integers(-5000, 5000, 64).astype(np.int32)
    f = rng.uniform(0.001, 0.01, 64).astype(np.float32)
    scale = float(np.abs(x).max() / 127.0)
    return x, w, bias, f, scale


class TestStemPlain:
    def test_vs_jax_fused_stem(self):
        """Against the JAX fused-stem entry point at its own test
        geometry (batch 128, 16 x 16), run in interpret mode."""
        x, w, bias, f, scale = _stem_case(128, 16, 16, seed=5)
        want = np.asarray(stem_conv_pool_nm(
            jnp.asarray(x), jconv.stem_s2d_weights(jnp.asarray(w), 3, 7),
            jnp.asarray(bias), jnp.asarray(f), scale, interpret=True))
        got = ops.stem_conv_pool(_t(x), _t(w.reshape(64, 3, 7, 7)),
                                 _t(bias), _t(f), scale)
        assert got.shape == (128, 64, 4, 4)
        np.testing.assert_array_equal(got.numpy(), want)

    def test_vs_jax_composition(self):
        """Against quantize -> 7x7/s2/p3 conv -> 3x3/s2/p1 pool in JAX."""
        x, w, bias, f, scale = _stem_case(2, 32, 32, seed=6)
        a = jepi.quantize_input(jnp.asarray(x), scale)
        a = jconv.conv2d_int8(a, jnp.asarray(w), jnp.asarray(bias),
                              kernel=7, stride=2, padding=3,
                              factors=jnp.asarray(f), relu=True)
        want = np.asarray(jpool.maxpool2d_int8(a, 3, 2, padding=1))
        got = ops.stem_conv_pool(_t(x), _t(w.reshape(64, 3, 7, 7)),
                                 _t(bias), _t(f), scale)
        np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------ dispatch: no fallback

class TestDispatch:
    def test_other_devices_raise(self):
        a = torch.zeros(4, 4, dtype=torch.int8, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            ops.matmul_int8(a, a)
        x = torch.zeros(1, 4, 5, 5, dtype=torch.int8, device="meta")
        w = torch.zeros(4, 4, 3, 3, dtype=torch.int8, device="meta")
        v = torch.zeros(4, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            ops.conv2d_int8(x, w, v, v, padding=1)
        with pytest.raises(ValueError, match="unsupported device"):
            ops.stem_conv_pool(torch.zeros(1, 3, 8, 8, device="meta"),
                               w, v, v, 0.1)
        packed = ops.pack_bsr(build_bsr_int8_direct(
            np.ones((32, 32), np.int8), 32), "meta")
        with pytest.raises(ValueError, match="unsupported device"):
            ops.bsr_matmul_wt(torch.zeros(4, 32, dtype=torch.int8,
                                          device="meta"), packed)
        with pytest.raises(ValueError, match="unsupported device"):
            ops.expand_add_int8(x, w[:, :, 0, 0], v, v, x, 1.0, 1.0, 1.0)
        q = torch.zeros(2, 8, 16, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            ops.flash_attention(q, q, q, causal=True)
        cpk = device_pack(pack_conv_bsr(np.ones((8, 32, 3, 3), np.int8), 1),
                          "meta")
        with pytest.raises(ValueError, match="unsupported device"):
            ops.sparse_conv2d_int8(torch.zeros((1, 32, 4, 4), dtype=torch.int8,
                                               device="meta"), cpk)
        with pytest.raises(ValueError, match="unsupported device"):
            ops.stem_conv_pool_int8(torch.zeros(1, 3, 8, 8, dtype=torch.int8,
                                                device="meta"), w, v, v)
        with pytest.raises(ValueError, match="unsupported device"):
            ops.quantize_s2d(torch.zeros(1, 3, 8, 8, device="meta"), 0.1)

    def test_plain_path_counts_no_launch(self):
        _kernels.reset_launch_counts()
        x, w, bias, f, scale = _stem_case(1, 16, 16, seed=7)
        ops.stem_conv_pool(_t(x), _t(w.reshape(64, 3, 7, 7)), _t(bias),
                           _t(f), scale)
        W = np.random.default_rng(8).integers(-128, 128, (64, 64))
        packed = ops.pack_bsr(build_bsr_int8_direct(W, 32), "cpu")
        ops.bsr_matmul_wt(torch.zeros((2, 64), dtype=torch.int8), packed)
        z = torch.zeros((1, 8, 2, 2), dtype=torch.int8)
        ops.expand_add_int8(z, torch.zeros((8, 8), dtype=torch.int8),
                            torch.zeros(8, dtype=torch.int32),
                            torch.ones(8), z, 1.0, 1.0, 1.0)
        q = torch.ones(2, 8, 16)
        ops.flash_attention(q, q, q, causal=True)
        cpk = device_pack(pack_conv_bsr(np.ones((8, 32, 3, 3), np.int8), 1),
                          "cpu")
        ops.sparse_conv2d_int8(torch.zeros((1, 32, 4, 4), dtype=torch.int8),
                               cpk)
        ops.stem_conv_pool_int8(torch.zeros((1, 3, 16, 16), dtype=torch.int8),
                                _t(w.reshape(64, 3, 7, 7)), _t(bias), _t(f))
        ops.quantize_s2d(_t(x), scale)
        assert _kernels.launch_counts() == {
            "stem_fused": 0, "conv_int8": 0, "matmul_int8": 0,
            "bsr_matmul": 0, "expand_add": 0, "flash_attention": 0,
            "sparse_conv": 0, "stem_int8": 0, "stem_pack": 0}

    def test_build_without_nvcc_raises(self, monkeypatch, tmp_path):
        monkeypatch.setenv("PATH", str(tmp_path))
        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
        monkeypatch.setattr(_kernels, "LIB_PATH",
                            str(tmp_path / "libkernels.so"))
        monkeypatch.setattr(_kernels, "BUILD_DIR", str(tmp_path))
        if _kernels.os.path.exists("/usr/local/cuda/bin/nvcc"):
            pytest.skip("this machine has nvcc")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _kernels.build()
