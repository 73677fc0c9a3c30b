"""PyTorch port: the zero-skip sparse conv (K8's plain version on the CPU)
and its packer against the JAX package, bit for bit (tolerance 0).

Every case of ``tests/test_sparse_conv.py`` runs through the JAX
``sparse_conv2d_int8`` (Pallas in interpret mode) and the port's, on the
same weights packed by both packers; the port's output also equals its
dense ``conv2d_int8_plain`` on the same weights.  The int32 sums are
exact and the epilogue is one IEEE f32 multiply per value.
"""

import dataclasses
import importlib
import json
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from resnet_accel_tpu.ops import requant_factors
from resnet_accel_tpu.ops import sparse_conv as J
from resnet_accel_tpu_torch import cli
from resnet_accel_tpu_torch.ops import (conv2d_int8_plain, pack_weight,
                                        sparse_conv2d_int8)
from resnet_accel_tpu_torch.sparse import conv_bsr as P

torch.set_num_threads(2)


def _weight(rng, o, c, k, block_o, block_c, sparsity):
    return P.tap_sparse_weight(rng, o, c, k, sparsity, block_o, block_c)


def _case_requant(rng, O, C, K, bo, bc, sparsity, shape, stride):
    w = _weight(rng, O, C, K, bo, bc, sparsity)
    x = rng.integers(-128, 128, shape).astype(np.int8)
    ws = rng.uniform(0.001, 0.01, O).astype(np.float32)
    f = requant_factors(0.02, ws, 0.06)
    return dict(w=w, x=x, bias=None, factors=f, relu=True, stride=stride,
                pack=dict(padding=1, block_o=bo, block_c=bc))


def _cases():
    """The cases of tests/test_sparse_conv.py, drawn from the same seeds:
    name -> weights, input, bias, factors, relu, stride, the packer's
    arguments and the JAX call's own (its image tile)."""
    out = {}
    for sp in (0.0, 0.5):
        rng = np.random.default_rng(1)
        w = _weight(rng, 128, 128, 3, 128, 128, sp)
        x = rng.integers(-128, 128, (2, 128, 10, 10)).astype(np.int8)
        bias = rng.integers(-2000, 2000, 128).astype(np.int32)
        out[f"bias_s1_sp{sp}"] = dict(w=w, x=x, bias=bias, factors=None,
                                      relu=False, stride=1,
                                      pack=dict(padding=1))
    out["requant_relu"] = _case_requant(np.random.default_rng(2), 64, 64, 3,
                                        64, 64, 0.4, (1, 64, 8, 8), 1)
    rng = np.random.default_rng(3)
    w = _weight(rng, 128, 128, 3, 128, 128, 0.3)
    out["batch3"] = dict(
        w=w, x=rng.integers(-128, 128, (3, 128, 6, 6)).astype(np.int8),
        bias=None, factors=None, relu=False, stride=1, pack=dict(padding=1),
        jax=dict(img_tile=2))
    out["all_zero"] = dict(w=np.zeros((128, 128, 3, 3), np.int8),
                           x=np.ones((1, 128, 6, 6), np.int8), bias=None,
                           factors=None, relu=False, stride=1,
                           pack=dict(padding=1))
    for hw in (8, 9):
        rng = np.random.default_rng(5)
        w = _weight(rng, 128, 128, 3, 128, 128, 0.4)
        x = rng.integers(-128, 128, (2, 128, hw, hw)).astype(np.int8)
        bias = rng.integers(-2000, 2000, 128).astype(np.int32)
        out[f"s2_3x3_hw{hw}"] = dict(w=w, x=x, bias=bias, factors=None,
                                     relu=False, stride=2,
                                     pack=dict(padding=1))
    rng = np.random.default_rng(6)
    w = _weight(rng, 128, 64, 1, 128, 64, 0.5)
    out["s2_1x1_ds"] = dict(
        w=w, x=rng.integers(-128, 128, (2, 64, 8, 8)).astype(np.int8),
        bias=None, factors=None, relu=False, stride=2,
        pack=dict(padding=0, block_c=64))
    out["s2_requant_relu"] = _case_requant(np.random.default_rng(7), 64, 64,
                                           3, 64, 64, 0.4, (1, 64, 9, 9), 2)
    rng = np.random.default_rng(4)
    out["o100"] = dict(
        w=rng.integers(-128, 128, (100, 128, 3, 3)).astype(np.int8),
        x=rng.integers(-128, 128, (1, 128, 6, 6)).astype(np.int8),
        bias=None, factors=None, relu=False, stride=1, pack=dict(padding=1))
    # Blocks off the kernel's 32-channel step: (block_c, block_o) = (16,
    # 14), with O = 30 padded to 42 by the packer, and (8, 4).
    for s in (1, 2):
        out[f"blocks16x14_s{s}"] = _case_requant(
            np.random.default_rng(10 + s), 30, 32, 3, 14, 16, 0.5,
            (2, 32, 8 + s, 8 + s), s)
    out["blocks8x4_s2"] = _case_requant(np.random.default_rng(13), 12, 16,
                                        3, 4, 8, 0.5, (1, 16, 7, 7), 2)
    return out


CASES = _cases()


def test_tap_sparse_weight_matches_sweep_tool(monkeypatch):
    """The copy draws what tools/tune_tpu.py's original draws.  The tool
    puts a path of its own on ``sys.path`` when imported; the list is
    restored after the test."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    tool = importlib.import_module("tools.tune_tpu")
    for args in ((256, 128, 3, 0.7), (512, 256, 1, 0.7), (100, 64, 3, 0.5)):
        np.testing.assert_array_equal(
            P.tap_sparse_weight(np.random.default_rng(9), *args),
            tool.tap_sparse_weight(np.random.default_rng(9), *args))


@pytest.mark.parametrize("name", sorted(CASES))
def test_pack_matches_jax(name):
    c = CASES[name]
    ref, got = J.pack_conv_bsr(c["w"], **c["pack"]), P.pack_conv_bsr(
        c["w"], **c["pack"])
    for f in dataclasses.fields(P.ConvBSR):
        a, b = getattr(ref, f.name), getattr(got, f.name)
        if f.name in ("blocks", "kh_of", "kw_of", "c_of", "o_of"):
            a = np.asarray(a)
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b and type(a) is type(b), f.name
    assert got.sparsity == ref.sparsity


def test_pack_refuses_channels_off_the_block():
    with pytest.raises(ValueError, match="multiple of block_c"):
        P.pack_conv_bsr(np.zeros((128, 96, 3, 3), np.int8), 1, block_c=128)


def test_device_pack_groups_by_output_block():
    w = _weight(np.random.default_rng(8), 256, 128, 3, 128, 64, 0.5)
    cbsr = P.pack_conv_bsr(w, padding=1, block_c=64)
    pk = P.device_pack(cbsr, "cpu")
    o_ptr = pk.o_ptr.tolist()
    assert pk.blocks.shape == (cbsr.nnz_source, 128, 64)
    assert o_ptr[0] == 0 and o_ptr[-1] == cbsr.nnz_source
    for ob in range(pk.n_ob):
        for i in range(o_ptr[ob], o_ptr[ob + 1]):
            kh, kw, cb = pk.kh[i].item(), pk.kw[i].item(), pk.cb[i].item()
            want = w[ob * 128:(ob + 1) * 128, cb * 64:(cb + 1) * 64, kh, kw]
            np.testing.assert_array_equal(pk.blocks[i].numpy(), want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sparse_conv_matches_jax_and_dense(name):
    c = CASES[name]
    x, w = c["x"], c["w"]
    O, C, K, _ = w.shape
    kw = dict(relu=c["relu"], stride=c["stride"])
    jb = None if c["bias"] is None else jnp.asarray(c["bias"])
    ref = np.asarray(J.sparse_conv2d_int8(
        jnp.asarray(x), J.pack_conv_bsr(w, **c["pack"]), bias=jb,
        factors=c["factors"], **kw, **c.get("jax", {})))
    pk = P.device_pack(P.pack_conv_bsr(w, **c["pack"]), "cpu")
    tb = None if c["bias"] is None else torch.from_numpy(c["bias"])
    tf = None if c["factors"] is None else torch.from_numpy(c["factors"])
    xt = torch.from_numpy(x)
    got = sparse_conv2d_int8(xt, pk, bias=tb, factors=tf, **kw)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert got.dtype == (torch.int8 if tf is not None else torch.int32)
    np.testing.assert_array_equal(got.numpy(), ref)
    if name == "all_zero":
        assert pk.nnz_source == 0 and not got.any()
    # the dense conv of the same weights, through a requant epilogue
    f = tf if tf is not None else torch.full((O,), 1e-4)
    bias = tb if tb is not None else torch.zeros(O, dtype=torch.int32)
    dense = conv2d_int8_plain(xt, pack_weight(w.reshape(O, -1), C, K, "cpu"),
                              bias, f, padding=c["pack"]["padding"], **kw)
    assert torch.equal(sparse_conv2d_int8(xt, pk, bias=bias, factors=f, **kw),
                       dense)


def test_bench_conv_cpu(capsys):
    """``bench --conv`` on the CPU at batch 2: one JSON line for each of
    the four ResNet-18 cases."""
    assert cli.main(["bench", "--conv", "--device", "cpu", "--batch", "2",
                     "--iters", "1"]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["case"] for r in rows] == [c[0] for c in cli.CONV_CASES]
    for r in rows:
        assert r["device"] == "cpu" and r["batch"] == 2
        assert 0 < r["nnz_blocks"] <= r["total_blocks"]
        assert r["dense_ms"] > 0 and r["sparse_ms"] > 0
        assert r["speedup_vs_dense"] == pytest.approx(
            r["dense_ms"] / r["sparse_ms"])
