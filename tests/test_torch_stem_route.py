"""PyTorch port: ResNet-18 through the space-to-depth stem
(``ResNet18Int8Module(stem_fused=False)``: K6's plain version, the 4x4 conv
through K2's, the max pool) against the JAX package, bit for bit.

The logits equal the JAX ``make_forward(stem_fused=False, stem_nm=True)``
(its K6 kernel in interpret mode), the numpy golden ``forward_golden`` and
the port's default route (the fused stem), at the small ImageNet geometry
of ``tests/test_torch_resnet18.py``: fp32 input at H = W = 32 and 34 (H % 4
= 2), int8 input, and H = 33, where the route does not apply and the fused
stem runs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from resnet_accel_tpu.models import resnet18 as J
from resnet_accel_tpu_torch.models import resnet18 as P
from resnet_accel_tpu_torch.ops import quantize_input
from resnet_accel_tpu_torch.runtime.engine import InferenceEngine

torch.set_num_threads(2)

STAGES = [(64, 1, 1), (128, 1, 2)]


@pytest.fixture(scope="module")
def models():
    params = J.init_resnet18_fp32(seed=0, num_classes=10, small_input=False,
                                  stages=STAGES)
    calib = np.random.default_rng(1).normal(
        0, 1, (4, 3, 64, 64)).astype(np.float32)
    ref = J.quantize_resnet18(params, calib, 10, small_input=False,
                              stages=STAGES)
    return ref, P.from_reference(ref)


def _input(hw, seed=3):
    return np.random.default_rng(seed).normal(
        0, 1, (2, 3, hw, hw)).astype(np.float32)


def _jax_route(ref, x):
    fwd = J.make_forward(ref, use_pallas=True, stem_fused=False,
                         stem_nm=True)
    return np.asarray(fwd(ref.as_device_params(), jnp.asarray(x)))


@pytest.fixture
def route_calls(monkeypatch):
    """Counts the calls of the route's quantize + space-to-depth."""
    calls = []

    def spy(x, scale):
        calls.append(tuple(x.shape))
        return P.quantize_s2d_nchw(x, scale)
    monkeypatch.setattr(P, "quantize_s2d", spy)
    return calls


@pytest.mark.parametrize("hw", [32, 34])
def test_route_matches_jax_golden_and_default(models, route_calls, hw):
    ref, port = models
    x = _input(hw)
    mod = P.ResNet18Int8Module(port, "cpu", stem_fused=False)
    got = mod(torch.from_numpy(x)).numpy()
    assert route_calls == [(2, 3, hw, hw)]
    np.testing.assert_array_equal(got, J.forward_golden(ref, x))
    np.testing.assert_array_equal(got, _jax_route(ref, x))
    np.testing.assert_array_equal(
        got, P.ResNet18Int8Module(port, "cpu")(torch.from_numpy(x)).numpy())
    assert torch.equal(mod.forward_plain(torch.from_numpy(x)),
                       torch.from_numpy(got))


def test_route_int8_input(models, route_calls):
    """Int8 images take space_to_depth_nchw, then the same conv."""
    ref, port = models
    x = _input(32, seed=4)
    q = quantize_input(torch.from_numpy(x), port.s_input)
    got = P.ResNet18Int8Module(port, "cpu", stem_fused=False)(q).numpy()
    assert route_calls == []
    np.testing.assert_array_equal(got, J.forward_golden(ref, x))
    np.testing.assert_array_equal(got, _jax_route(ref, q.numpy()))
    np.testing.assert_array_equal(
        got, P.ResNet18Int8Module(port, "cpu")(q).numpy())


def test_odd_size_takes_the_fused_stem(models, route_calls):
    ref, port = models
    x = _input(33, seed=5)
    mod = P.ResNet18Int8Module(port, "cpu", stem_fused=False)
    got = mod(torch.from_numpy(x)).numpy()
    assert route_calls == []
    np.testing.assert_array_equal(got, J.forward_golden(ref, x))
    np.testing.assert_array_equal(
        got, P.ResNet18Int8Module(port, "cpu")(torch.from_numpy(x)).numpy())


def test_engine_on_cpu(models, route_calls):
    ref, port = models
    x = _input(32, seed=6)
    eng = InferenceEngine(port, device="cpu", stem_fused=False)
    assert eng.module.stem_s2d_w is not None
    res = eng.run_inference(x)
    assert len(route_calls) == 1
    np.testing.assert_array_equal(res.logits, J.forward_golden(ref, x))
    assert InferenceEngine(port, device="cpu").module.stem_s2d_w is None


def test_small_input_ignores_the_option(route_calls):
    stages = [(64, 1, 1)]
    p = P.init_resnet18_fp32(seed=0, num_classes=4, small_input=True,
                             stages=stages)
    calib = np.random.default_rng(0).normal(0, 1, (2, 3, 8, 8))
    model = P.quantize_resnet18(p, calib, 4, small_input=True, stages=stages)
    x = torch.from_numpy(_input(8, seed=7))
    mod = P.ResNet18Int8Module(model, "cpu", stem_fused=False)
    assert mod.stem_s2d_w is None
    assert torch.equal(mod(x), P.ResNet18Int8Module(model, "cpu")(x))
    assert route_calls == []
