"""PyTorch port: the binding of the native host library (``native/``),
built from its sources by ``g++`` at first use, against the numpy goldens
and the port's own copies, and its ``BatchLoader`` against the numpy
formula and, bit for bit, against ``QuantizingLoader`` over
``preprocess_imagenet`` (the host path ``InferenceEngine.stream`` takes
without it).  Skips only where ``g++`` is absent.
"""

import shutil

import numpy as np
import pytest
import torch

from resnet_accel_tpu import golden as jgolden
from resnet_accel_tpu.sparse import serialize_hw_stream
from resnet_accel_tpu.sparse import build_bsr_int8_direct as jbuild_bsr
from resnet_accel_tpu_torch import golden, native
from resnet_accel_tpu_torch.runtime.engine import (IMAGENET_MEAN,
                                                   IMAGENET_STD,
                                                   QuantizingLoader,
                                                   preprocess_imagenet)
from resnet_accel_tpu_torch.sparse.bsr import build_bsr_int8_direct

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the native library cannot be built")
    return native.lib()


def _rng(seed):
    return np.random.default_rng(seed)


class TestGolden:
    def test_self_test_and_version(self):
        assert native.self_test() == 0
        assert "native" in native.version()

    def test_build_is_keyed_and_reused(self):
        assert native.build() == native.build()
        assert native._digest() in native.build()

    @pytest.mark.parametrize("m,k,n", [(7, 33, 12), (1, 1, 1), (16, 64, 5)])
    def test_matmul(self, m, k, n):
        a = _rng(0).integers(-128, 128, (m, k)).astype(np.int8)
        b = _rng(1).integers(-128, 128, (k, n)).astype(np.int8)
        np.testing.assert_array_equal(
            native.matmul_int8(a, b), a.astype(np.int32) @ b.astype(np.int32))

    def test_matmul_shape_mismatch_raises(self):
        with pytest.raises(ValueError, match="shape mismatch"):
            native.matmul_int8(np.zeros((2, 3), np.int8),
                               np.zeros((4, 2), np.int8))

    @pytest.mark.parametrize("block", [14, 8])
    def test_bsr_matmul_wt(self, block):
        w = _rng(1).integers(-128, 128, (42, 70)).astype(np.int8)
        w[0:14, 14:42] = 0
        a = _rng(2).integers(-128, 128, (3, 70)).astype(np.int8)
        bsr = build_bsr_int8_direct(w, block)
        got = native.bsr_matmul_int8_wt(a, bsr.data, bsr.row_ptr,
                                        bsr.col_idx, block, block, 42)
        np.testing.assert_array_equal(got, golden.bsr_matmul_int8_wt(
            a, bsr.data, bsr.row_ptr, bsr.col_idx, block, block, N=42))
        np.testing.assert_array_equal(
            got, a.astype(np.int32) @ w.astype(np.int32).T)

    @pytest.mark.parametrize("bad", ["row_ptr", "block_shape"])
    def test_bsr_arrays_checked(self, bad):
        w = _rng(1).integers(-128, 128, (28, 28)).astype(np.int8)
        bsr = build_bsr_int8_direct(w, 14)
        row_ptr, blocks = bsr.row_ptr.copy(), bsr.data
        if bad == "row_ptr":
            row_ptr[-1] += 1                     # one block past the store
        else:
            blocks = blocks[:, :7]
        with pytest.raises(ValueError, match="inconsistent BSR"):
            native.bsr_matmul_int8_wt(np.zeros((1, 28), np.int8), blocks,
                                      row_ptr, bsr.col_idx, 14, 14, 28)
        if bad == "row_ptr":
            with pytest.raises(ValueError, match="inconsistent BSR"):
                native.bsr_serialize_hw(blocks, row_ptr, bsr.col_idx, 2)

    @pytest.mark.parametrize("in_s,out_s", [(0.013, 0.07), (1.0, 2.0),
                                            (0.5, 0.25)])
    def test_requantize(self, in_s, out_s):
        x = _rng(2).integers(-(2**20), 2**20, 1000).astype(np.int32)
        x[:4] = [1, 3, -1, -3]                  # ties at 0.5 factors
        fct = np.float32(in_s) / np.float32(out_s)
        want = np.clip(np.rint(x.astype(np.float32) * fct), -128,
                       127).astype(np.int8)
        got = native.requantize_int32_to_int8(x, in_s, out_s)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, jgolden.requantize_int32_to_int8(x, in_s, out_s))

    @pytest.mark.parametrize("relu", [False, True])
    def test_requantize_q16(self, relu):
        x = _rng(21).integers(-(2**31), 2**31, 4096).astype(np.int64)
        x = np.concatenate([x, [2**31 - 1, -(2**31), 0, -1, -65537]]
                           ).astype(np.int32)
        for s in [0x0001, 0x8000, 0xFFFF, 0x18000,
                  golden.scale_to_q16(0.37)]:
            v = np.maximum(x.astype(np.int64), 0) if relu else \
                x.astype(np.int64)
            want = np.clip((v * (s & 0xFFFF)) >> 16, -128, 127)
            got = native.requantize_q16(x, s, relu=relu)
            np.testing.assert_array_equal(got, want.astype(np.int8))

    def test_add_residual(self):
        m = _rng(3).integers(-128, 128, 512).astype(np.int8)
        r = _rng(4).integers(-128, 128, 512).astype(np.int8)
        s = (0.03, 0.05, 0.04)
        f32 = np.float32
        want = np.clip(np.rint((m.astype(f32) * f32(s[0])
                                + r.astype(f32) * f32(s[1])) / f32(s[2])),
                       -128, 127).astype(np.int8)
        got = native.add_residual_int8(m, r, *s)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jgolden.add_residual_int8(m, r,
                                                                     *s))

    @pytest.mark.parametrize("pool,stride,pad", [(3, 2, 1), (2, 2, 0)])
    def test_maxpool(self, pool, stride, pad):
        x = _rng(4).integers(-128, 128, (3, 9, 9)).astype(np.int8)
        got = native.maxpool2d_int8(x, pool, stride, pad)
        want = torch.nn.functional.max_pool2d(
            torch.from_numpy(x).float()[None], pool, stride, pad)[0]
        np.testing.assert_array_equal(got, want.numpy().astype(np.int8))
        np.testing.assert_array_equal(
            got, jgolden.maxpool2d_int8(x, pool, stride, padding=pad))

    def test_avgpool_global(self):
        x = _rng(5).integers(-128, 128, (6, 7, 7)).astype(np.int8)
        x[0] = -128                       # a negative sum: C truncation
        s = x.reshape(6, -1).astype(np.int64).sum(1) + 49 // 2
        want = np.sign(s) * (np.abs(s) // 49)
        got = native.avgpool_global_int8(x)
        np.testing.assert_array_equal(got, want.astype(np.int8))
        np.testing.assert_array_equal(got, jgolden.avgpool_global_int8(x))

    @pytest.mark.parametrize("stride,pad,bias", [(1, 1, True), (2, 0, False)])
    def test_conv(self, stride, pad, bias):
        x = _rng(5).integers(-128, 128, (3, 8, 8)).astype(np.int8)
        w = _rng(6).integers(-128, 128, (6, 3, 3, 3)).astype(np.int8)
        b = _rng(7).integers(-500, 500, 6).astype(np.int32) if bias else None
        got = native.conv2d_int8(x, w, b, stride, pad)
        want = torch.nn.functional.conv2d(
            torch.from_numpy(x).double()[None], torch.from_numpy(w).double(),
            None if b is None else torch.from_numpy(b).double(), stride,
            pad)[0].numpy().astype(np.int32)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, jgolden.conv2d_int8_simple(x, w, b, stride, pad))

    def test_bsr_pack_matches_the_port_packer(self):
        w = _rng(6).integers(-128, 128, (60, 90)).astype(np.int8)
        w[14:28] = 0
        blocks, row_ptr, col_idx = native.bsr_pack(w, 14, 14)
        bsr = build_bsr_int8_direct(w, 14)
        np.testing.assert_array_equal(blocks, bsr.data)
        np.testing.assert_array_equal(row_ptr, bsr.row_ptr)
        np.testing.assert_array_equal(col_idx, bsr.col_idx)

    def test_hw_stream_matches_python(self):
        w = _rng(7).integers(-128, 128, (28, 56)).astype(np.int8)
        w[:14, :14] = 0
        bsr = jbuild_bsr(w, 14)
        got = native.bsr_serialize_hw(bsr.data, bsr.row_ptr, bsr.col_idx,
                                      bsr.num_block_cols)
        assert got == serialize_hw_stream(bsr)


def _loader(**kw):
    imgs = _rng(3).integers(0, 256, (17, 1, 4, 4)).astype(np.uint8)
    labs = np.arange(17, dtype=np.int32)
    args = dict(batch=4, mean=[0.1307], std=[0.3081], quant_scale=0.02,
                shuffle=False, seed=9, n_threads=2, depth=2)
    args.update(kw)
    return imgs, labs, native.BatchLoader(imgs, labs, **args)


class TestBatchLoader:
    def test_matches_numpy_formula(self):
        imgs, labs, ld = _loader()
        with ld:
            assert ld.batches_per_epoch == 4       # drop-last: 17 // 4
            for j in range(5):                     # wraps into epoch 1
                x, y = ld.next()
                sl = slice(4 * (j % 4), 4 * (j % 4) + 4)
                f = ((imgs[sl].astype(np.float32) / np.float32(255))
                     - np.float32(0.1307)) / np.float32(0.3081) \
                    / np.float32(0.02)
                ref = np.clip(np.rint(f), -128, 127).astype(np.int8)
                np.testing.assert_array_equal(x, ref)
                np.testing.assert_array_equal(y, labs[sl])

    @pytest.mark.parametrize("threads,depth", [(4, 3), (8, 2)])
    def test_thread_count_invariant(self, threads, depth):
        _, _, a = _loader(shuffle=True, n_threads=1, depth=2)
        _, _, b = _loader(shuffle=True, n_threads=threads, depth=depth)
        with a, b:
            for _ in range(9):                     # crosses two epochs
                xa, ya = a.next()
                xb, yb = b.next()
                np.testing.assert_array_equal(xa, xb)
                np.testing.assert_array_equal(ya, yb)

    def test_shuffle_covers_epoch(self):
        _, labs, ld = _loader(shuffle=True)
        with ld:
            seen = [int(v) for _ in range(ld.batches_per_epoch)
                    for v in ld.next()[1]]
        assert len(set(seen)) == len(seen) == 16
        assert set(seen) <= set(labs.tolist())

    def test_different_seeds_differ(self):
        _, _, a = _loader(shuffle=True, seed=1)
        _, _, b = _loader(shuffle=True, seed=2)
        with a, b:
            ya = np.concatenate([a.next()[1] for _ in range(3)])
            yb = np.concatenate([b.next()[1] for _ in range(3)])
        assert not np.array_equal(ya, yb)

    @pytest.mark.parametrize("bad", [
        dict(batch=5), dict(std=[0.0]), dict(quant_scale=0.0),
        dict(n_threads=0), dict(depth=0), dict(mean=[0.1, 0.2, 0.3],
                                               std=[1.0, 1.0, 1.0])])
    def test_invalid_config_raises(self, bad):
        imgs = np.zeros((4, 1, 2, 2), np.uint8)
        args = dict(batch=2, mean=[0.0], std=[1.0], quant_scale=0.1)
        args.update(bad)
        with pytest.raises(ValueError, match="invalid loader"):
            native.BatchLoader(imgs, None, **args)

    @pytest.mark.parametrize("s_input", [0.0207, 2.64 / 127, 0.0625])
    def test_equals_quantizing_loader_bit_for_bit(self, s_input):
        """ImageNet mean and std, CHW uint8 items, in order: the native
        loader's batches equal QuantizingLoader over preprocess_imagenet."""
        u8 = _rng(11).integers(0, 256, (6, 9, 11, 3)).astype(np.uint8)
        u8[0, 0, :3] = [0, 255, 128]
        chw = np.ascontiguousarray(u8.transpose(0, 3, 1, 2))
        ql = QuantizingLoader(preprocess_imagenet(u8), s_input, 3)
        with native.BatchLoader(chw, None, 3, IMAGENET_MEAN, IMAGENET_STD,
                                s_input, shuffle=False, n_threads=3) as ld:
            for _ in range(4):
                got, _ = ld.next()
                want, _ = ql.next()
                assert got.dtype == want.dtype == np.int8
                np.testing.assert_array_equal(got, want)

    def test_next_into_a_tensor(self):
        imgs, labs, ld = _loader()
        with ld:
            ref, _ = _loader()[2].next()
            out = torch.full((4, 1, 4, 4), 99, dtype=torch.int8)
            got, y = ld.next(out=out)
            assert got is out
            np.testing.assert_array_equal(out.numpy(), ref)
            np.testing.assert_array_equal(y, labs[:4])
            flat = np.zeros(4 * 16, np.int8)         # a numpy buffer, flat
            got, _ = ld.next(out=flat)
            assert got is flat and flat.any()

    @pytest.mark.parametrize("out", [
        torch.zeros((4, 1, 4, 4), dtype=torch.int16),
        torch.zeros((4, 1, 4, 3), dtype=torch.int8),
        torch.zeros((4, 1, 4, 8), dtype=torch.int8)[..., ::2],
        np.zeros((4, 16), np.uint8)])
    def test_next_refuses_a_wrong_buffer(self, out):
        with _loader()[2] as ld:
            with pytest.raises(ValueError, match="out"):
                ld.next(out=out)

    def test_closed_loader_raises(self):
        _, _, ld = _loader()
        ld.close()
        ld.close()                                  # idempotent
        with pytest.raises(RuntimeError, match="closed"):
            ld.next()


class TestIsAvailable:
    def test_true_where_the_library_loads(self):
        assert native.is_available() is True
        assert native.is_available() == (native.lib() is not None)

    @pytest.mark.parametrize("fault", ["build", "load"])
    def test_false_when_the_build_or_the_load_fails(self, fault,
                                                    monkeypatch, tmp_path):
        """A fresh build directory, then g++ handed a flag it refuses, or a
        file at the library's path that is no library."""
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
        if fault == "build":
            monkeypatch.setattr(native, "CXXFLAGS",
                                native.CXXFLAGS + ["-fno-such-flag"])
        else:
            (tmp_path / f"libresnet_accel_host-{native._digest()}.so"
             ).write_bytes(b"not a shared object")
        assert native.is_available() is False
        with pytest.raises(RuntimeError if fault == "build" else OSError):
            native.lib()
