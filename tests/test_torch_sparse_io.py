"""PyTorch port: ``sparse/io.py``, ``conv_weight_to_2d``, the quantizers of
``quant.py`` and the fixture tree of ``sparse/fixtures.py`` against the JAX
package's modules.

The port keeps numpy copies of them; a file either package writes must be
byte-identical to the other's and readable by the other, and every array
and statistic equal (tolerance 0).  The fixture tree seeds its transformer
weights with Python's per-process ``str`` hash, so the two trees are
compared within this one process.
"""

import json
import os

import numpy as np
import pytest

from resnet_accel_tpu import quant as jquant
from resnet_accel_tpu.sparse import bsr as jbsr
from resnet_accel_tpu.sparse import fixtures as jfix
from resnet_accel_tpu.sparse import io as jio
from resnet_accel_tpu_torch import quant
from resnet_accel_tpu_torch.sparse import bsr, fixtures, io

LAYER_FILES = ("weights.bsr", "row_ptr.npy", "col_idx.npy",
               "weights.meta.json")
#: (N, K, block_h, block_w, sparsity): the reference's 14 x 14 FC1 at its
#: width, 8 x 8 blocks, ragged edges, an all-zero and a dense weight.
CASES = [(128, 9216, 14, 14, 0.9), (64, 128, 8, 8, 0.8),
         (70, 300, 14, 28, 0.5), (30, 50, 8, 8, 1.0), (16, 16, 4, 4, 0.0)]


def _weight(n, k, bh, bw, sparsity, seed=0):
    rng = np.random.default_rng(seed + n + k)
    w = rng.integers(-128, 128, (n, k)).astype(np.int8)
    keep = rng.random((-(-n // bh), -(-k // bw))) >= sparsity
    return w * np.repeat(np.repeat(keep, bh, 0), bw, 1)[:n, :k].astype(
        np.int8)


def _pair(case):
    n, k, bh, bw, sp = case
    w = _weight(n, k, bh, bw, sp)
    return (bsr.build_bsr_int8_direct(w, bh, bw),
            jbsr.build_bsr_int8_direct(w, bh, bw))


def _same_bsr(a, b):
    for f in ("data", "row_ptr", "col_idx"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert (tuple(a.shape), a.block_h, a.block_w) == \
        (tuple(b.shape), b.block_h, b.block_w)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = _read(p)
    return out


@pytest.mark.parametrize("case", CASES)
def test_layer_dir_written_and_read_by_both(tmp_path, case):
    mine, theirs = _pair(case)
    io.save_layer_dir(mine, str(tmp_path / "port"), "fc1")
    jio.save_layer_dir(theirs, str(tmp_path / "jax"), "fc1")
    for f in LAYER_FILES:
        assert _read(tmp_path / "port" / f) == _read(tmp_path / "jax" / f), f
    assert io.bsr_metadata(mine, "fc1") == jio.bsr_metadata(theirs, "fc1")
    _same_bsr(io.load_layer_dir(str(tmp_path / "jax")), theirs)
    _same_bsr(jio.load_layer_dir(str(tmp_path / "port")), mine)


def test_fixture_layout_read_by_both(tmp_path):
    """The fixture layout: ``weights_int8.bsr`` with row_ptr and col_idx
    only in ``weights.meta.json``."""
    mine, _ = _pair(CASES[1])
    io.save_layer_dir(mine, str(tmp_path), "q")
    os.rename(tmp_path / "weights.bsr", tmp_path / "weights_int8.bsr")
    os.remove(tmp_path / "row_ptr.npy")
    os.remove(tmp_path / "col_idx.npy")
    _same_bsr(io.load_layer_dir(str(tmp_path)),
              jio.load_layer_dir(str(tmp_path)))
    _same_bsr(io.load_layer_dir(str(tmp_path)), mine)


def test_layer_dir_refuses_wrong_sizes(tmp_path):
    mine, _ = _pair(CASES[1])
    with pytest.raises(ValueError, match="INT8"):
        io.save_layer_dir(bsr.BSRMatrix(
            mine.data.astype(np.float32), mine.row_ptr, mine.col_idx,
            mine.shape, 8, 8), str(tmp_path), "f")
    io.save_layer_dir(mine, str(tmp_path), "q")
    with open(tmp_path / "weights.bsr", "ab") as f:
        f.write(b"\0")
    for load in (io.load_layer_dir, jio.load_layer_dir):
        with pytest.raises(ValueError, match="expected"):
            load(str(tmp_path))


def test_scales_bias(tmp_path):
    assert io.load_layer_scales_bias(str(tmp_path)) == (None, None)
    rng = np.random.default_rng(1)
    np.save(tmp_path / "scales.npy", rng.random(64))
    np.save(tmp_path / "bias.npy", rng.normal(size=64).astype(np.float32))
    got = io.load_layer_scales_bias(str(tmp_path))
    want = jio.load_layer_scales_bias(str(tmp_path))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got[0].dtype == np.float32


@pytest.mark.parametrize("case", CASES)
def test_hw_stream_both_ways(case):
    mine, theirs = _pair(case)
    buf = io.serialize_hw_stream(mine)
    assert buf == jio.serialize_hw_stream(theirs)
    bh, bw = mine.block_h, mine.block_w
    _same_bsr(io.deserialize_hw_stream(buf, bh, bw, mine.shape), theirs)
    _same_bsr(jio.deserialize_hw_stream(buf, bh, bw, mine.shape), mine)
    padded = io.deserialize_hw_stream(buf, bh, bw)
    assert padded.shape == mine.padded_shape == \
        jio.deserialize_hw_stream(buf, bh, bw).shape


@pytest.mark.parametrize("which", ["row_ptr", "col_idx"])
def test_hw_stream_u16_range(which):
    """u16 indices: more than 65535 blocks, or a block column past it, is
    refused by both."""
    if which == "col_idx":
        args = (np.ones((1, 1, 1), np.int8), np.array([0, 1], np.int32),
                np.array([66000], np.int32), (1, 66001))
    else:
        args = (np.ones((65536, 1, 1), np.int8),
                np.array([0, 65536], np.int32),
                np.arange(65536, dtype=np.int32), (1, 65536))
    for mod, m in ((io, bsr), (jio, jbsr)):
        with pytest.raises(ValueError, match=which):
            mod.serialize_hw_stream(m.BSRMatrix(*args, 1, 1))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("crc", [False, True])
def test_dma_image_both_ways(case, crc):
    mine, theirs = _pair(case)
    buf = io.pack_dma_image(mine, crc=crc)
    assert buf == jio.pack_dma_image(theirs, crc=crc)
    geo = (mine.num_block_rows, mine.nnz_blocks, mine.block_h, mine.block_w)
    _same_bsr(io.unpack_dma_image(buf, *geo, shape=mine.shape, crc=crc),
              theirs)
    _same_bsr(jio.unpack_dma_image(buf, *geo, shape=mine.shape, crc=crc),
              mine)
    assert io.unpack_dma_image(buf, *geo, crc=crc).shape == \
        jio.unpack_dma_image(buf, *geo, crc=crc).shape


def test_dma_image_crc_catches_corruption():
    mine, _ = _pair(CASES[1])
    buf = bytearray(io.pack_dma_image(mine, crc=True))
    buf[len(buf) // 2] ^= 0x10
    geo = (mine.num_block_rows, mine.nnz_blocks, mine.block_h, mine.block_w)
    for mod in (io, jio):
        with pytest.raises(ValueError, match="CRC mismatch"):
            mod.unpack_dma_image(bytes(buf), *geo, crc=True)


def test_conv_weight_to_2d():
    w = np.random.default_rng(2).normal(size=(32, 16, 3, 3)).astype(
        np.float32)
    got = bsr.conv_weight_to_2d(w)
    assert got.shape == (32, 144)
    assert np.array_equal(got, jbsr.conv_weight_to_2d(w))
    with pytest.raises(ValueError, match="4-D"):
        bsr.conv_weight_to_2d(w[0])


def _arrays():
    rng = np.random.default_rng(3)
    w = rng.normal(0, 0.1, (16, 8, 3, 3)).astype(np.float32)
    w[3] = 0.0                         # an all-zero channel: the 1e-12 guard
    return [w, rng.normal(0, 2, (10, 128)).astype(np.float32),
            rng.uniform(-1, 3, (7, 5)).astype(np.float32)]


@pytest.mark.parametrize("i", range(3))
def test_quantizers_equal_jax(i):
    x = _arrays()[i]
    q, s = quant.quantize_symmetric_per_tensor(x)
    jq, js = jquant.quantize_symmetric_per_tensor(x)
    assert q.dtype == jq.dtype and np.array_equal(q, jq) and s == js
    for axis in (0, 1):
        got = quant.quantize_asymmetric_per_channel(x, axis)
        want = jquant.quantize_asymmetric_per_channel(x, axis)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        qa, sa, zp = got
        assert np.array_equal(quant.dequantize(qa, sa, zp, axis),
                              jquant.dequantize(qa, sa, zp, axis))
        qc, sc = quant.quantize_symmetric_per_channel(x, axis)
        assert np.array_equal(quant.dequantize(qc, sc, axis=axis),
                              jquant.dequantize(qc, sc, axis=axis))
        assert quant.compute_quantization_error(x, qc, sc, axis) == \
            jquant.compute_quantization_error(x, qc, sc, axis)
    assert quant.compute_quantization_error(x, q, s) == \
        jquant.compute_quantization_error(x, q, s)


def test_quantize_params_per_channel_equal_jax():
    rng = np.random.default_rng(4)
    params = {"conv1.weight": rng.normal(0, 0.3, (32, 1, 3, 3)),
              "conv1.bias": rng.normal(0, 0.1, 32),
              "fc1.weight": rng.normal(0, 0.01, (128, 9216)),
              "fc1.bias": np.zeros(128, np.float32)}
    got = quant.quantize_params_per_channel(params)
    want = jquant.quantize_params_per_channel(params)
    assert list(got) == list(want)
    for name in got:
        g, w = got[name], want[name]
        assert sorted(g) == sorted(w), name
        for key in g:
            if isinstance(g[key], np.ndarray):
                assert g[key].dtype == w[key].dtype
                assert np.array_equal(g[key], w[key]), (name, key)
            else:
                assert g[key] == w[key], (name, key)
    with pytest.raises(ValueError, match="unrecognized"):
        quant.quantize_params_per_channel({"fc1.running_mean": np.ones(2)})


@pytest.mark.parametrize("shape,block,sparsity,seed", [
    ((64, 128), 8, 0.8, 42), ((128, 9216), 8, 0.9, 9258),
    ((30, 50), 8, 0.5, 0)])
def test_make_sparse_weight_and_export(tmp_path, shape, block, sparsity,
                                       seed):
    w = fixtures.make_sparse_weight(shape, block, sparsity, seed=seed)
    assert np.array_equal(w, jfix.make_sparse_weight(shape, block, sparsity,
                                                     seed=seed))
    fixtures.export_fixture("t", w, str(tmp_path / "port"), block,
                            {"target_sparsity": sparsity * 100})
    jfix.export_fixture("t", w, str(tmp_path / "jax"), block,
                        {"target_sparsity": sparsity * 100})
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")


def test_generate_all_fixtures_equals_jax(tmp_path):
    made = fixtures.generate_all_fixtures(str(tmp_path / "port"), seed=42)
    jmade = jfix.generate_all_fixtures(str(tmp_path / "jax"), seed=42)
    assert list(made) == list(jmade) and len(made) == 12
    for k in made:
        assert os.path.relpath(made[k], tmp_path / "port") == \
            os.path.relpath(jmade[k], tmp_path / "jax")
    port, jax_tree = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert sorted(port) == sorted(jax_tree) and len(port) == 12 * 7
    for rel in port:
        assert port[rel] == jax_tree[rel], rel
    meta = json.loads(port[os.path.join("mlp", "fc_9216_128",
                                        "metadata.json")])
    assert meta["input_dim"] == 9216 and 85 < meta["actual_sparsity"] < 95
