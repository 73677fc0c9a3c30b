"""PyTorch port: the ResNet-18 slice against the JAX package.

Init draws identical weights; calibration agrees to float tolerance; the
forward, with the JAX package's quantized model carried across by
``from_reference``, is bit-identical to the numpy golden ``forward_golden``
and to the JAX ``make_forward(use_pallas=True)`` (tolerance 0).  Where the
port and JAX ever disagree, the golden decides.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from resnet_accel_tpu.models import resnet18 as J
from resnet_accel_tpu_torch.models import resnet18 as P
from resnet_accel_tpu_torch.runtime.engine import InferenceEngine

torch.set_num_threads(2)

# (small_input, input size, stages, classes): (a) CIFAR geometry, full
# ResNet-18 plan; (b) ImageNet geometry (7x7 stem + max pool) at 64 x 64
# with two narrow stages, one of them downsampling.
GEOMETRIES = {
    "cifar": (True, 32, None, 10),
    "imagenet": (False, 64, [(64, 1, 1), (128, 1, 2)], 10),
}


@pytest.fixture(scope="module", params=sorted(GEOMETRIES))
def models(request):
    small, hw, stages, nc = GEOMETRIES[request.param]
    params = J.init_resnet18_fp32(seed=0, num_classes=nc,
                                  small_input=small, stages=stages)
    calib = np.random.default_rng(1).normal(
        0, 1, (4, 3, hw, hw)).astype(np.float32)
    ref = J.quantize_resnet18(params, calib, nc, small_input=small,
                              stages=stages)
    return dict(ref=ref, port=P.from_reference(ref), params=params,
                calib=calib, hw=hw, stages=stages, small=small, nc=nc)


def _input(hw, seed=3):
    return np.random.default_rng(seed).normal(
        0, 1, (2, 3, hw, hw)).astype(np.float32)


class TestInit:
    @pytest.mark.parametrize("small_input", [False, True])
    def test_identical_to_jax(self, small_input):
        a = J.init_resnet18_fp32(seed=4, num_classes=1000,
                                 small_input=small_input)
        b = P.init_resnet18_fp32(seed=4, num_classes=1000,
                                 small_input=small_input)
        assert list(a) == list(b)
        for k in a:
            assert np.array_equal(a[k], b[k]), k

    def test_fold_bn_identical_to_jax(self):
        p = J.init_resnet18_fp32(seed=5, num_classes=10, small_input=True)
        a, b = J.fold_all_bn(p), P.fold_all_bn(p)
        assert list(a) == list(b)
        for k in a:
            assert np.array_equal(a[k], b[k]), k


class TestQuantize:
    def test_weight_quant_identical_to_reference(self):
        from resnet_accel_tpu import quant as ref_quant
        from resnet_accel_tpu_torch import quant
        rng = np.random.default_rng(6)
        w = rng.normal(0, 0.1, (16, 8, 3, 3)).astype(np.float32)
        w[3] = 0.0                          # all-zero channel: eps guard
        b = rng.normal(0, 0.5, 16).astype(np.float32)
        q, s = quant.quantize_symmetric_per_channel(w, axis=0)
        rq, rs = ref_quant.quantize_symmetric_per_channel(w, axis=0)
        np.testing.assert_array_equal(q, rq)
        np.testing.assert_array_equal(s, rs)
        np.testing.assert_array_equal(quant.bias_to_int32(b, 0.037, s),
                                      ref_quant.bias_to_int32(b, 0.037, rs))

    def test_matches_jax(self, models):
        """Same weights and int32 biases; scales to rtol 1e-5 (the
        calibration forward sums floats in another order)."""
        got = P.quantize_resnet18(models["params"], models["calib"],
                                  models["nc"], small_input=models["small"],
                                  stages=models["stages"])
        ref = models["ref"]
        np.testing.assert_allclose(got.s_input, ref.s_input, rtol=1e-5)
        for (name, a), (_, b) in zip(ref.named_convs(), got.named_convs()):
            np.testing.assert_array_equal(a.w2d, b.w2d, err_msg=name)
            np.testing.assert_allclose(b.factors, a.factors, rtol=1e-5,
                                       err_msg=name)
            assert (a.in_channels, a.kernel, a.stride, a.padding,
                    a.relu) == (b.in_channels, b.kernel, b.stride,
                                b.padding, b.relu), name
        for a, b in zip(ref.blocks, got.blocks):
            np.testing.assert_allclose(
                [b.s_in, b.s_main, b.s_res, b.s_out],
                [a.s_in, a.s_main, a.s_res, a.s_out], rtol=1e-5)
        np.testing.assert_array_equal(got.fc_w, ref.fc_w)
        np.testing.assert_allclose(got.fc_deq, ref.fc_deq, rtol=1e-5)

    def test_npz_round_trip(self, models, tmp_path):
        port = models["port"]
        path = str(tmp_path / "model.npz")
        port.save_npz(path)
        back = P.ResNet18Int8.load_npz(path)
        for f in ("fc_w", "fc_b", "fc_deq"):
            a, b = getattr(port, f), getattr(back, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        assert (back.s_input, back.small_input, back.num_classes) == \
            (port.s_input, port.small_input, port.num_classes)
        assert [n for n, _ in back.named_convs()] == \
            [n for n, _ in port.named_convs()]
        for (name, qa), (_, qb) in zip(port.named_convs(),
                                       back.named_convs()):
            for f in dataclasses.fields(P.QConv):
                a, b = getattr(qa, f.name), getattr(qb, f.name)
                if isinstance(a, np.ndarray):
                    assert a.dtype == b.dtype and np.array_equal(a, b), name
                else:
                    assert a == b and type(a) is type(b), (name, f.name)
        for a, b in zip(port.blocks, back.blocks):
            assert (a.s_in, a.s_main, a.s_res, a.s_out) == \
                (b.s_in, b.s_main, b.s_res, b.s_out)
        x = torch.from_numpy(_input(models["hw"]))
        np.testing.assert_array_equal(
            P.ResNet18Int8Module(back, "cpu")(x).numpy(),
            P.ResNet18Int8Module(port, "cpu")(x).numpy())

    def test_from_reference_refuses_bottleneck(self):
        """A bottleneck comes across as a ``QBottleneck`` only when its c3
        is the 1x1 stride-1 conv without ReLU that the expand kernel
        computes; any other c3 is refused."""
        stages = [(16, 1, 1)]
        p = J.init_resnet18_fp32(seed=0, num_classes=4, small_input=True,
                                 stages=stages, bottleneck=True)
        calib = np.random.default_rng(0).normal(0, 1, (1, 3, 8, 8))
        ref = J.quantize_resnet18(p, calib, 4, small_input=True,
                                  stages=stages, bottleneck=True)
        assert isinstance(P.from_reference(ref).blocks[0], P.QBottleneck)
        blk = ref.blocks[0]
        bad = dataclasses.replace(
            ref, blocks=[dataclasses.replace(blk, conv3=blk.conv2)])
        with pytest.raises(ValueError, match="bottleneck"):
            P.from_reference(bad)


class TestForward:
    def test_bit_exact_vs_golden_and_jax(self, models):
        ref, port = models["ref"], models["port"]
        x = _input(models["hw"])
        got = P.ResNet18Int8Module(port, "cpu")(torch.from_numpy(x))
        assert got.dtype == torch.float32 and got.shape == (2, models["nc"])
        golden = J.forward_golden(ref, x)
        jax_out = np.asarray(J.make_forward(ref, use_pallas=True)(
            ref.as_device_params(), jnp.asarray(x)))
        np.testing.assert_array_equal(got.numpy(), golden)
        np.testing.assert_array_equal(jax_out, golden)

    def test_plain_forward_matches_forward(self, models):
        mod = P.ResNet18Int8Module(models["port"], "cpu")
        x = torch.from_numpy(_input(models["hw"], seed=4))
        assert torch.equal(mod(x), mod.forward_plain(x))

    def test_engine_on_cpu(self, models):
        x = _input(models["hw"], seed=5)
        eng = InferenceEngine(models["port"], device="cpu")
        res = eng.run_inference(x)
        np.testing.assert_array_equal(res.logits,
                                      J.forward_golden(models["ref"], x))
        np.testing.assert_array_equal(res.predictions,
                                      res.logits.argmax(-1))
        assert len(res.top5) == 2 and len(res.top5[0]) == 5
        bench = eng.benchmark(x, iters=2)
        assert bench.device == "cpu" and bench.images_per_s > 0
