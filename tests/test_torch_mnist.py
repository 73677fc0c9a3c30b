"""PyTorch port: the INT8 MNIST CNN against the JAX package, the engine's
MNIST path and the ``infer --model mnist`` and ``bench`` commands.

The model is made from seeded arrays and from a synthetic directory in
the reference's int8 export layout (``from_int8_dir``), with fc1
block-pruned at 0.9 on 128 x 128 blocks.  Scales and factors are identical
to the JAX package's; the logits, with fc1 dense (K3's plain version) and
through the zero-skip GEMM (K4's plain version), are bit-identical
(tolerance 0) to the JAX ``make_forward(use_pallas=True)`` and the golden
``forward_golden``.
"""

import ast
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from resnet_accel_tpu.models import mnist_cnn as J
from resnet_accel_tpu.runtime import preprocess_mnist as j_preprocess_mnist
from resnet_accel_tpu_torch import cli
from resnet_accel_tpu_torch.models import mnist_cnn as P
from resnet_accel_tpu_torch.quant import quantize_symmetric_per_channel
from resnet_accel_tpu_torch.runtime.engine import (InferenceEngine,
                                                   preprocess_mnist)

torch.set_num_threads(2)

SHAPES = {"conv1": (32, 1, 3, 3), "conv2": (64, 32, 3, 3),
          "fc1": (128, 9216), "fc2": (10, 128)}


def make_arrays(seed=0, fc1_sparsity=0.9):
    """He-init float weights quantized per channel, fc1's 128 x 128 blocks
    zeroed with probability ``fc1_sparsity``, small float biases."""
    rng = np.random.default_rng(seed)
    weights, scales, biases = {}, {}, {}
    for layer, shape in SHAPES.items():
        fan_in = int(np.prod(shape[1:]))
        w = rng.normal(0, np.sqrt(2.0 / fan_in), shape).astype(np.float32)
        if layer == "fc1":
            mask = rng.random((1, 72)) < fc1_sparsity
            w[np.repeat(np.repeat(mask, 128, 0), 128, 1)] = 0.0
        weights[layer], scales[layer] = quantize_symmetric_per_channel(w)
        biases[layer] = rng.normal(0, 0.05, shape[0]).astype(np.float32)
    return weights, scales, biases


def write_int8_dir(path, weights, scales, biases):
    """The reference's export layout: per layer int8 weights, per-channel
    scales, an int8 bias and its per-tensor scale."""
    for layer in SHAPES:
        np.save(path / f"{layer}_weight_int8.npy", weights[layer])
        np.save(path / f"{layer}_weight_scales.npy", scales[layer])
        b_scale = float(np.abs(biases[layer]).max()) / 127.0
        np.save(path / f"{layer}_bias_int8.npy", np.clip(
            np.rint(biases[layer] / b_scale), -128, 127).astype(np.int8))
        with open(path / f"{layer}_bias_scale.json", "w") as f:
            json.dump({"scale": b_scale}, f)


def _images(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, (n, 28, 28)).astype(np.uint8)


@pytest.fixture(scope="module")
def int8_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("int8")
    write_int8_dir(path, *make_arrays())
    return path


@pytest.fixture(scope="module")
def models(int8_dir):
    calib = _images(16, 1)
    ref = J.MNISTCNNInt8.from_int8_dir(str(int8_dir), calib)
    return dict(ref=ref, port=P.MNISTCNNInt8.from_int8_dir(str(int8_dir),
                                                           calib))


def _assert_same_model(a, b):
    for f in dataclasses.fields(P.MNISTCNNInt8):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "fc1_bsr":
            assert (x is None) == (y is None)
            if x is not None:
                for g in ("data", "row_ptr", "col_idx"):
                    assert np.array_equal(getattr(x, g), getattr(y, g))
                assert (x.shape, x.block_h, x.block_w) == \
                    (y.shape, y.block_h, y.block_w)
        elif isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert tuple(x) == tuple(y), f.name


class TestModel:
    def test_from_arrays_identical(self):
        weights, scales, biases = make_arrays(seed=3)
        act = (0.021, 0.0113, 0.0049, 0.0021)
        ref = J.MNISTCNNInt8.from_arrays(weights, scales, biases, act)
        port = P.MNISTCNNInt8.from_arrays(weights, scales, biases, act)
        _assert_same_model(port, P.from_reference(ref))
        assert port.act_scales == tuple(ref.act_scales)

    def test_from_int8_dir_identical(self, models):
        ref, port = models["ref"], models["port"]
        assert port.act_scales == ref.act_scales
        _assert_same_model(port, P.from_reference(ref))

    def test_with_fc1_bsr_identical(self, models):
        ref = models["ref"].with_fc1_bsr(128)
        port = models["port"].with_fc1_bsr(128)
        _assert_same_model(port, P.from_reference(ref))
        assert port.sparsity_report() == ref.sparsity_report()
        assert port.sparsity_report()["fc1"] >= 0.8
        assert models["port"].sparsity_report() == {}

    def test_preprocess_identical(self):
        imgs = _images(3, 2)
        np.testing.assert_array_equal(preprocess_mnist(imgs),
                                      j_preprocess_mnist(imgs))


class TestForward:
    @pytest.mark.parametrize("fc1_bsr", [False, True])
    def test_bit_exact_vs_jax_and_golden(self, models, fc1_bsr):
        ref = models["ref"].with_fc1_bsr(128) if fc1_bsr else models["ref"]
        port = P.from_reference(ref)
        x = preprocess_mnist(_images(3, 4))
        got = P.MNISTCNNInt8Module(port, "cpu")(torch.from_numpy(x))
        assert got.dtype == torch.float32 and got.shape == (3, 10)
        golden = J.forward_golden(ref, x)
        jax_out = np.asarray(J.make_forward(ref, use_pallas=True)(
            ref.as_device_params(), jnp.asarray(x)))
        np.testing.assert_array_equal(got.numpy(), golden)
        np.testing.assert_array_equal(jax_out, golden)
        assert len(np.unique(golden)) > 10   # not a degenerate model

    def test_plain_forward_matches_forward(self, models):
        mod = P.MNISTCNNInt8Module(models["port"].with_fc1_bsr(128), "cpu")
        assert mod.fc1_packed is not None
        x = torch.from_numpy(preprocess_mnist(_images(4, 5)))
        assert torch.equal(mod(x), mod.forward_plain(x))
        dense = P.MNISTCNNInt8Module(models["port"], "cpu")
        assert torch.equal(mod(x), dense(x))

    def test_engine(self, models):
        model = models["port"].with_fc1_bsr(128)
        eng = InferenceEngine(model, device="cpu")
        assert eng.get_model_sparsity() == model.sparsity_report()
        x = preprocess_mnist(_images(5, 6))
        res = eng.run_inference(x)
        ref = models["ref"].with_fc1_bsr(128)
        np.testing.assert_array_equal(res.logits, J.forward_golden(ref, x))
        assert len(res.top5) == 5 and len(res.top5[0]) == 5


class TestCLI:
    def test_infer_mnist(self, models, int8_dir, tmp_path, capsys):
        imgs = _images(16, 1)       # the calibration set of the fixture
        path = tmp_path / "digits.npy"
        np.save(path, imgs)
        rc = cli.main(["infer", "--model", "mnist", "--weights",
                       str(int8_dir), "--input", str(path), "--device",
                       "cpu", "--limit", "3"])
        out = capsys.readouterr().out
        assert rc == 0 and "images/s on cpu" in out
        want = J.forward_golden(models["ref"],
                                j_preprocess_mnist(imgs[:3])).argmax(1)
        for i, c in enumerate(want):
            assert f"sample {i}: class {c} " in out

    def test_infer_mnist_needs_weights(self, tmp_path):
        path = tmp_path / "digits.npy"
        np.save(path, _images(1, 1))
        with pytest.raises(SystemExit, match="weights"):
            cli.main(["infer", "--model", "mnist", "--input", str(path),
                      "--device", "cpu"])

    def test_bench(self, tmp_path, capsys):
        out_json = tmp_path / "bench.json"
        rc = cli.main(["bench", "--sizes", "256", "--sparsities", "0.0,0.5",
                       "--batch", "32", "--device", "cpu",
                       "--no-cpu-baseline", "--iters", "2",
                       "--output", str(out_json)])
        lines = capsys.readouterr().out.splitlines()
        assert rc == 0 and lines[0] == "bench on cpu"
        rows = [ast.literal_eval(line) for line in lines[1:]]
        assert [r["sparsity"] for r in rows] == [0.0, 0.5]
        assert rows[0]["nnz_blocks"] == 4 and rows[0]["speedup_vs_dense"] \
            == 1.0
        assert all(r["M"] == 32 and r["N"] == r["K"] == 256
                   and r["latency_us"] > 0 and "speedup_vs_cpu" not in r
                   for r in rows)
        with open(out_json) as f:
            assert json.load(f) == {"device": "cpu", "rows": rows}
