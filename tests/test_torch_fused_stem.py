"""PyTorch port: the int8-input stem (K10's plain version on the CPU), the
int8-input forward and the engine's ``stream`` against the JAX package,
bit for bit (tolerance 0).

``fused_stem_pool`` (pooled and unpooled) equals the JAX function with its
Pallas kernels in interpret mode, at 64 x 64 (H/4 = 16, two bands) rather
than the JAX test's 224 x 224, which the interpreter takes long over.  The
int8 forward equals JAX ``make_forward`` fed the same int8 images, and the
port's own fp32-input forward of the images they were quantized from.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from resnet_accel_tpu.models import resnet18 as J
from resnet_accel_tpu.ops import fused_stem as JF
from resnet_accel_tpu_torch.models import resnet18 as P
from resnet_accel_tpu_torch.ops import (fused_stem_pool, quantize_input,
                                        stem_conv_pool_int8,
                                        stem_conv_pool_int8_plain,
                                        stem_conv_pool_plain)
from resnet_accel_tpu_torch.runtime.engine import (AccelErrorCode,
                                                   AcceleratorError,
                                                   InferenceEngine,
                                                   QuantizingLoader)

torch.set_num_threads(2)

# (small_input, input size, stages, classes): two stages, so that JAX's
# Pallas kernels in interpret mode stay quick; the stride-2 stage keeps a
# downsample in the trunk
GEOMETRIES = {
    "cifar": (True, 32, [(64, 1, 1), (128, 1, 2)], 10),
    "imagenet": (False, 64, [(64, 1, 1), (128, 1, 2)], 10),
}


@pytest.fixture(scope="module")
def stem_model():
    rng = np.random.default_rng(11)
    fp32 = J.init_resnet18_fp32(seed=3, num_classes=10, small_input=False,
                                stages=GEOMETRIES["imagenet"][2])
    calib = rng.normal(0, 1, (2, 3, 64, 64)).astype(np.float32)
    ref = J.quantize_resnet18(fp32, calib, 10, small_input=False,
                              stages=GEOMETRIES["imagenet"][2])
    x = rng.normal(0, 1, (2, 3, 64, 64)).astype(np.float32)
    return ref, x


def _stem_tensors(ref):
    st = ref.stem
    return (torch.from_numpy(np.ascontiguousarray(
                st.w2d.reshape(-1, 3, 7, 7))),
            torch.from_numpy(np.asarray(st.bias, np.int32)),
            torch.from_numpy(np.asarray(st.factors, np.float32)))


@pytest.mark.parametrize("pool", [True, False])
def test_fused_stem_pool_matches_jax(stem_model, pool):
    ref, x = stem_model
    p = {k: jnp.asarray(v) for k, v in ref.as_device_params().items()}
    want = np.asarray(JF.fused_stem_pool(
        jnp.asarray(x), p["stem.w"], p["stem.b"], p["stem.f"], ref.s_input,
        relu=ref.stem.relu, pool=pool, interpret=True))
    w, b, f = _stem_tensors(ref)
    got = fused_stem_pool(torch.from_numpy(x), w, b, f, ref.s_input,
                          pool=pool)
    assert got.shape == ((2, 16, 16, 64) if pool else (2, 32, 32, 64))
    np.testing.assert_array_equal(got.numpy(), want)


def test_fused_stem_pool_refuses_geometry(stem_model):
    ref, _ = stem_model
    w, b, f = _stem_tensors(ref)
    with pytest.raises(ValueError, match="divisible by 4"):
        fused_stem_pool(torch.zeros(1, 3, 30, 30), w, b, f, ref.s_input)


@pytest.mark.parametrize("hw", [64, 37])
def test_int8_stem_plain_matches_k1_plain(stem_model, hw):
    """K10 of the quantized images is K1 of the fp32 ones (its plain
    versions here), also off the multiples of 4."""
    ref, _ = stem_model
    x = torch.from_numpy(np.random.default_rng(hw).normal(
        0, 1, (2, 3, hw, hw)).astype(np.float32))
    w, b, f = _stem_tensors(ref)
    q = quantize_input(x, ref.s_input)
    got = stem_conv_pool_int8_plain(q, w, b, f)
    assert torch.equal(got, stem_conv_pool_plain(x, w, b, f, ref.s_input))
    assert torch.equal(stem_conv_pool_int8(q, w, b, f), got)


@pytest.fixture(scope="module", params=sorted(GEOMETRIES))
def models(request):
    small, hw, stages, nc = GEOMETRIES[request.param]
    params = J.init_resnet18_fp32(seed=0, num_classes=nc,
                                  small_input=small, stages=stages)
    calib = np.random.default_rng(1).normal(
        0, 1, (4, 3, hw, hw)).astype(np.float32)
    ref = J.quantize_resnet18(params, calib, nc, small_input=small,
                              stages=stages)
    x = np.random.default_rng(3).normal(0, 1, (4, 3, hw, hw)).astype(
        np.float32)
    return ref, P.from_reference(ref), x


def test_int8_forward_matches_jax_and_fp32_forward(models):
    ref, port, x = models
    q = quantize_input(torch.from_numpy(x), port.s_input)
    mod = P.ResNet18Int8Module(port, "cpu")
    got = mod(q)
    jax_out = np.asarray(J.make_forward(ref, use_pallas=True)(
        ref.as_device_params(), jnp.asarray(q.numpy())))
    np.testing.assert_array_equal(got.numpy(), jax_out)
    assert torch.equal(got, mod(torch.from_numpy(x)))
    assert torch.equal(got, mod.forward_plain(q))


def test_stream_matches_run_inference(models):
    _, port, x = models
    eng = InferenceEngine(port, device="cpu")
    labels = np.arange(len(x)) % 10
    loader = QuantizingLoader(x, port.s_input, 2, labels=labels)
    res = eng.stream(loader, 2)
    np.testing.assert_array_equal(res.logits, eng.run_inference(x).logits)
    np.testing.assert_array_equal(res.labels, labels)
    np.testing.assert_array_equal(res.predictions, res.logits.argmax(-1))
    assert res.images_per_s > 0 and 0.0 <= res.accuracy <= 1.0
    one = eng.stream(QuantizingLoader(x, port.s_input, 4), 1)
    assert one.labels is None
    np.testing.assert_array_equal(one.logits, res.logits)
    with pytest.raises(ValueError, match="accuracy"):
        one.accuracy


def test_stream_refuses(models):
    _, port, x = models
    eng = InferenceEngine(port, device="cpu")
    loader = QuantizingLoader(x, port.s_input, 2)
    with pytest.raises(AcceleratorError, match="n_batches") as ei:
        eng.stream(loader, 0)
    assert ei.value.code == AccelErrorCode.INVALID_CONFIG

    class Fp32Loader:
        has_labels = False

        def next(self):
            return x[:2], None
    with pytest.raises(ValueError, match="int8"):
        eng.stream(Fp32Loader(), 1)
