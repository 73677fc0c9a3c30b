"""PyTorch port: quantization-aware training (``train/qat.py``) against the
JAX package's, on a seeded synthetic MNIST split and tiny ResNets
(``tests/test_qat.py``'s MNIST classes skip where the real files are
absent; its checks run here on the synthetic split).

Tolerances, each with its reason:
- 0 (exact) for ``fake_quant`` on the same inputs and scales, for
  ``export_qat``'s arrays against the JAX result carried over by
  ``from_reference``, for its int8 forward against the golden, for the
  port's calibration against the port's quantizer (the same code), for the
  frozen running statistics, and for masked weights.
- Forward: MNIST logits rtol 1e-5, atol 1e-5, loss rtol 1e-5; the
  observed absmax rtol 1e-5; the calibrated scales against JAX's rtol 1e-5
  (float32 convolutions summed in another order than XLA's).  The
  ResNet's logits atol 5e-3 and loss rtol 1e-3: there a float32 ulp apart
  can round a tap's activation to the next grid step (below), which moves
  a logit by about a step times an fc weight.
- Gradients against ``jax.grad``: per parameter, the L2 norm of the
  difference within 5e-3 of the gradient's, and every entry within 1e-2 of
  the largest.  Not the 1e-4 of the float trainers: fake-quant rounds each
  tap to a grid, so a float32 ulp apart can round an activation to the next
  step, which moves the max pools' ties and every gradient behind it (they
  agree to 1.2e-3 at worst here); the layers after the last tap agree to
  rtol 1e-4 with atol 1e-6 relative to the largest entry.
- Trajectories (Adam, 3-4 steps): the loss history rtol 1e-3, the EMA
  absmax rtol 1e-4 (the taps of parameters a few steps apart); at least
  90 % of each parameter's elements (all but one of a parameter of fewer
  than ten) within lr / 4 of JAX's (the worst
  printed), none beyond 2 lr a step: Adam divides by the root of the
  second moment, so the gradient differences above, and the rounding flips
  that parameters an ulp apart meet after the first step, move a
  small-gradient element by a fair share of lr (here up to 0.67 lr in 3
  steps; the updates' L2 distance from JAX's, printed, up to 20 % on the
  tiny ResNet's fc weight).

The ResNet inputs are 18 x 18, not ``tests/test_qat.py``'s 16 x 16: the
fc input is the fake-quant of a mean over the last stage's positions, and
over 8 x 8 of them a mean of grid values can sit exactly on a half step,
where two float32 sums in different orders round to neighbouring steps
(the fc weight's gradient then differs by 4 % in L2); over 9 x 9, an odd
count, no mean can.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
import optax

from resnet_accel_tpu.models import mnist_cnn as JMC
from resnet_accel_tpu.train import qat as J
from resnet_accel_tpu_torch.models import mnist_cnn as PMC
from resnet_accel_tpu_torch.models import resnet18 as PR
from resnet_accel_tpu_torch.runtime.engine import preprocess_mnist
from resnet_accel_tpu_torch.train import mnist as PM
from resnet_accel_tpu_torch.train import qat as P
from resnet_accel_tpu_torch.train import resnet18 as PT
from resnet_accel_tpu_torch.train.blocksparse import (BlockCfg,
                                                      make_mask_fn,
                                                      prune_blocks_global)
from resnet_accel_tpu_torch.utils.mnist_data import synthetic_digits

torch.set_num_threads(2)

CPU = torch.device("cpu")
TINY = ((8, 1, 1), (16, 1, 2))


def qat_grads_close(got, want, exact=()):
    for k in want:
        a, b = got[k], np.asarray(want[k])
        s = np.abs(b).max()
        if k in exact:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6 * s,
                                       err_msg=k)
        rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        print(f"{k}: |diff| / |grad| {rel:.3g}, max diff / max "
              f"{np.abs(a - b).max() / max(s, 1e-30):.3g}")
        assert rel <= 5e-3, k
        assert np.abs(a - b).max() <= 1e-2 * s, k


def close_updates(got, want, start, lr, steps):
    """Each trained parameter: at least 90 % of its elements (all but one
    of a small one) within lr / 4 of JAX's (the worst, and the update's L2
    distance from JAX's, printed), none beyond 2 lr a step."""
    for k in want:
        if k.endswith((".running_mean", ".running_var")):
            continue
        a, b = np.asarray(got[k]), np.asarray(want[k])
        d = np.abs(a - b)
        du, dw = a - start[k], b - start[k]
        rel = np.linalg.norm(du - dw) / max(np.linalg.norm(dw), 1e-30)
        ok = float(np.mean(d <= 0.25 * lr))
        worst = np.unravel_index(int(np.argmax(d)), d.shape)
        print(f"{k}: update off JAX's by {rel:.3g} in L2, {ok:.4f} of "
              f"{d.size} within lr / 4; worst {worst}: port {a[worst]!r} "
              f"jax {b[worst]!r}")
        assert (1 - ok) * d.size <= max(1, 0.1 * d.size), k
        assert d.max() <= 2 * lr * steps, k


@pytest.fixture(scope="module")
def digits():
    return synthetic_digits(160, seed=0)


class TestFakeQuant:
    """tests/test_qat.py::TestFakeQuant on the port, and against JAX."""

    def test_forward_is_quantize_dequantize(self):
        x = torch.tensor([0.24, 0.26, -1.0])
        out = P.fake_quant(x, 0.1).numpy()
        np.testing.assert_allclose(out, [0.2, 0.3, -1.0], atol=1e-6)
        v = np.random.default_rng(0).normal(0, 3, 1000).astype(np.float32)
        v[:4] = [0.25, 0.35, -0.45, 12.75]                  # ties
        for s in (0.1, 0.05, 1e-3):
            assert np.array_equal(
                P.fake_quant(torch.from_numpy(v), s).numpy(),
                np.asarray(J.fake_quant(jnp.asarray(v), jnp.float32(s))))

    def test_gradient_is_straight_through(self):
        x = torch.tensor([0.24, 3.7], requires_grad=True)
        P.fake_quant(x, 0.1).sum().backward()
        np.testing.assert_allclose(x.grad.numpy(), [1.0, 1.0])
        w = torch.tensor([[0.1, -0.1], [10.0, -10.0]], requires_grad=True)
        P.fake_quant_per_channel(w).sum().backward()
        # the scale sits inside the detached part: no gradient through it
        np.testing.assert_array_equal(w.grad.numpy(), np.ones((2, 2)))

    def test_per_channel_scales(self):
        w = np.asarray([[0.1, -0.1], [10.0, -10.0]], np.float32)
        out = P.fake_quant_per_channel(torch.from_numpy(w)).numpy()
        np.testing.assert_allclose(out, w, rtol=2e-2)
        w = np.random.default_rng(1).normal(0, 0.2, (16, 8, 3, 3)).astype(
            np.float32)
        w[3] = 0.0
        assert np.array_equal(
            P.fake_quant_per_channel(torch.from_numpy(w)).numpy(),
            np.asarray(J.fake_quant_per_channel(jnp.asarray(w))))


def test_mnist_qat_forward_and_gradients(digits):
    imgs, labels = digits
    p = PM.init_mnist_params(0)
    x, y = PM.normalize_mnist(imgs[:32]), labels[:32]
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    _, jobs0 = J._qat_forward(jp, {t: jnp.float32(1.0) for t in J.TAPS},
                              jnp.asarray(x), False)

    def jloss(pp):
        lg, obs = J._qat_forward(pp, jobs0, jnp.asarray(x), True)
        return optax.softmax_cross_entropy_with_integer_labels(
            lg, jnp.asarray(y)).mean(), (lg, obs)

    (jl, (jlg, jobs)), jg = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jp)
    tp = PM.to_device(p, CPU)
    with torch.no_grad():
        _, obs0 = P._qat_forward(tp, {t: 1.0 for t in P.TAPS},
                                 torch.from_numpy(x), False)
    lg, obs = P._qat_forward(tp, obs0, torch.from_numpy(x), True)
    loss = F.cross_entropy(lg, torch.from_numpy(y).long())
    loss.backward()
    for t in P.TAPS:
        np.testing.assert_allclose(float(obs0[t]), float(jobs0[t]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(obs[t]), float(jobs[t]), rtol=1e-5)
    np.testing.assert_allclose(lg.detach().numpy(), np.asarray(jlg),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    qat_grads_close({k: v.grad.numpy() for k, v in tp.items()}, jg,
                    exact=("fc2.weight", "fc2.bias", "fc1.bias"))


@pytest.mark.parametrize("masked", [False, True])
def test_mnist_qat_trajectory_and_export(digits, masked):
    """qat_finetune against JAX's (fc1's 128 x 128 blocks pruned at 0.5 and
    kept at 0 by ``mask_fn`` in the second case), then ``export_qat`` equal
    to JAX's and served on the port bit for bit with the golden."""
    imgs, labels = digits
    params = PM.init_mnist_params(0)
    jmask = pmask = None
    if masked:
        from resnet_accel_tpu.train.blocksparse import BlockCfg as JBlockCfg
        from resnet_accel_tpu.train.blocksparse import (
            make_mask_fn as j_make_mask_fn)
        cfg = {"fc1.weight": BlockCfg(128, 128, 0.05)}
        masks = prune_blocks_global(params, 0.5, cfg)
        shapes = {"fc1.weight": params["fc1.weight"].shape}
        pmask = make_mask_fn(masks, cfg, shapes)
        jmask = j_make_mask_fn(masks, {"fc1.weight": JBlockCfg(128, 128,
                                                               0.05)}, shapes)
        params = {k: v.copy() for k, v in params.items()}
        params["fc1.weight"] *= np.repeat(masks["fc1.weight"], 128, 1)
    want = J.qat_finetune(imgs, labels, params=params, epochs=1,
                          batch_size=32, seed=1, mask_fn=jmask)
    got = P.qat_finetune(imgs, labels, params=params, epochs=1,
                         batch_size=32, seed=1, mask_fn=pmask, device="cpu")
    np.testing.assert_allclose(got.history[0]["loss"],
                               want.history[0]["loss"], rtol=1e-3)
    for t in P.TAPS:
        np.testing.assert_allclose(got.act_absmax[t], want.act_absmax[t],
                                   rtol=1e-4)
    assert all(v > 0 for v in got.act_absmax.values())
    close_updates(got.params, want.params, params, 2e-4, 4)
    if masked:
        dead = np.repeat(np.repeat(~masks["fc1.weight"], 128, 0), 128, 1)
        assert np.all(got.params["fc1.weight"][dead] == 0)
    # export_qat: the same arrays as JAX's export of the same result
    jmodel = J.export_qat(want)
    pmodel = P.export_qat(P.QATResult(params=want.params,
                                      act_absmax=want.act_absmax,
                                      history=want.history))
    carried = PMC.from_reference(jmodel)
    for f in ("conv1_w", "conv2_w", "fc1_w", "fc2_w", "conv1_b", "conv2_b",
              "fc1_b", "fc2_b", "fc2_w_scales", "conv1_f", "conv2_f",
              "fc1_f"):
        a, b = getattr(pmodel, f), getattr(carried, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert pmodel.act_scales == carried.act_scales
    x = preprocess_mnist(imgs[:8])
    for m, ref_model in ((pmodel, jmodel),
                         (pmodel.with_fc1_bsr(128),
                          jmodel.with_fc1_bsr(128))):
        with torch.inference_mode():
            out = PMC.MNISTCNNInt8Module(m, "cpu")(torch.from_numpy(x))
        np.testing.assert_array_equal(out.numpy(),
                                      JMC.forward_golden(ref_model, x))


@pytest.fixture(scope="module")
def resnet_setup():
    """tests/test_qat.py::TestResNetQAT's setup, trained by the port."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (96, 3, 18, 18)).astype(np.float32)
    y = (x[:, 0, :8, :8].mean(axis=(1, 2)) > 0).astype(np.int32)
    st = PT.train_resnet18(x, y, epochs=2, batch_size=32, lr=0.02, seed=0,
                           num_classes=2, small_input=True, stages=TINY,
                           device="cpu")
    return x, y, PT.export_inference_params(st)


def test_calibration_matches_quantizer_and_jax(resnet_setup):
    x, _, flat = resnet_setup
    s_in, s_tap = P.calibrate_resnet_act_scales(
        flat, x[:64], small_input=True, stages=TINY, batch_size=32,
        percentile=99.9)
    model = PR.quantize_resnet18(flat, x[:64], num_classes=2,
                                 small_input=True, stages=TINY,
                                 calib_batch_size=32, calib_percentile=99.9)
    assert s_in == model.s_input
    assert s_tap["stem"] == model.blocks[0].s_in
    assert s_tap["b0.out"] == model.blocks[0].s_out
    assert s_tap["b1.ds"] == model.blocks[1].s_res
    j_in, j_tap = J.calibrate_resnet_act_scales(
        flat, x[:64], small_input=True, stages=TINY, batch_size=32,
        percentile=99.9)
    assert s_in == j_in and sorted(s_tap) == sorted(j_tap)
    for k in j_tap:
        np.testing.assert_allclose(s_tap[k], j_tap[k], rtol=1e-5, err_msg=k)


def test_max_pool_tie_routing_as_reduce_window():
    """QAT's pool after fake-quant sees many equal values: F.max_pool2d
    routes each window's gradient to one of them, as JAX's reduce_window
    does, and to the same one."""
    rng = np.random.default_rng(2)
    a = np.round(rng.normal(0, 1, (2, 3, 9, 10)) * 2).astype(np.float32)
    w = rng.normal(0, 1, (2, 3, 5, 5)).astype(np.float32)
    t = torch.tensor(a, requires_grad=True)
    (F.max_pool2d(t, 3, 2, padding=1) * torch.from_numpy(w)).sum().backward()

    def jpool(v):
        m = jax.lax.reduce_window(v, jnp.float32(-np.inf), jax.lax.max,
                                  (1, 1, 3, 3), (1, 1, 2, 2),
                                  ((0, 0), (0, 0), (1, 1), (1, 1)))
        return (m * w).sum()

    assert np.array_equal(t.grad.numpy(),
                          np.asarray(jax.grad(jpool)(jnp.asarray(a))))


@pytest.mark.parametrize("small", [True, False])
def test_resnet_qat_forward_and_gradients(resnet_setup, small):
    x, y, flat = resnet_setup
    stages = TINY
    if not small:   # the ImageNet stem (a 7x7/s2 conv and the pool), one
        stages = TINY[:1]   # stage: JAX differentiates it op by op, below
        flat = PR.init_resnet18_fp32(seed=4, num_classes=2,
                                     small_input=False, stages=stages)
    s_in, s_tap = P.calibrate_resnet_act_scales(flat, x[:32],
                                                small_input=small,
                                                stages=stages)
    p, s = PT.split_params(flat)
    xb, yb = x[:16], y[:16]

    def jloss(pp):
        lg = J._qat_resnet_forward(pp, {k: jnp.asarray(v)
                                        for k, v in s.items()},
                                   jnp.asarray(xb), s_in, s_tap, small,
                                   stages, False)
        return optax.softmax_cross_entropy_with_integer_labels(
            lg, jnp.asarray(yb)).mean(), lg

    # jit(grad(reduce_window)) fails in jax 0.9.0 (the ImageNet stem's
    # pool): differentiate that one eagerly
    vg = jax.value_and_grad(jloss, has_aux=True)
    (jl, jlg), jg = (jax.jit(vg) if small else vg)(
        {k: jnp.asarray(v) for k, v in p.items()})
    tp = PM.to_device(p, CPU)
    lg = P._qat_resnet_forward(tp, {k: torch.from_numpy(v)
                                    for k, v in s.items()},
                               torch.from_numpy(xb), s_in, s_tap, small,
                               stages, False)
    loss = F.cross_entropy(lg, torch.from_numpy(yb).long())
    loss.backward()
    np.testing.assert_allclose(lg.detach().numpy(), np.asarray(jlg),
                               rtol=1e-5, atol=5e-3)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-3)
    qat_grads_close({k: v.grad.numpy() for k, v in tp.items()}, jg)


def test_resnet_qat_trajectory_structure_and_masks(resnet_setup):
    """tests/test_qat.py::test_qat_preserves_structure_and_masks on the
    port, and its trajectory against JAX's."""
    x, y, flat = resnet_setup
    key = "layer2.0.conv1.weight"
    mask = np.ones_like(flat[key])
    mask[:4] = 0.0
    flat_m = dict(flat)
    flat_m[key] = flat[key] * mask
    tmask = torch.from_numpy(mask)
    kw = dict(epochs=1, batch_size=32, lr=1e-3, small_input=True,
              stages=TINY, calib_x=x[:64], calib_percentile=99.9)
    out = P.qat_finetune_resnet(
        flat_m, x, y, mask_fn=lambda p: {**p, key: p[key] * tmask},
        device="cpu", **kw)
    want = J.qat_finetune_resnet(
        flat_m, x, y, mask_fn=lambda p: {**p, key: p[key] * jnp.asarray(
            mask)}, **kw)
    assert set(out) == set(flat) == set(want)
    for k in flat:
        assert out[k].shape == np.asarray(flat[k]).shape
        if k.endswith((".running_mean", ".running_var")):
            np.testing.assert_array_equal(out[k], flat[k])
    np.testing.assert_array_equal(out[key][:4], 0.0)
    assert not np.allclose(out["fc.weight"], flat["fc.weight"])
    close_updates(out, want, flat_m, 1e-3, 3)


def test_resnet_qat_keeps_the_int8_gap(resnet_setup):
    """tests/test_qat.py::test_qat_shrinks_quantization_error on the port:
    the deployed int8 logits' gap to the fp32 ones does not grow by more
    than a quarter after QAT, and the QAT'd model serves."""
    x, y, flat = resnet_setup

    def int8_gap(f):
        model = PR.quantize_resnet18(f, x[:64], num_classes=2,
                                     small_input=True, stages=TINY,
                                     calib_batch_size=32,
                                     calib_percentile=99.9)
        with torch.inference_mode():
            q = PR.ResNet18Int8Module(model, "cpu")(
                torch.from_numpy(x[:64])).numpy()
            lf, _ = PR._float_forward_taps(
                PR.fold_all_bn(f, stages=TINY), torch.from_numpy(x[:64]),
                True, stages=TINY)
        return float(np.abs(q - lf.numpy()).mean())

    before = int8_gap(flat)
    out = P.qat_finetune_resnet(flat, x, y, epochs=2, batch_size=32,
                                lr=1e-3, small_input=True, stages=TINY,
                                calib_x=x[:64], calib_percentile=99.9,
                                device="cpu")
    after = int8_gap(out)
    assert np.isfinite(after) and after < before * 1.25


def test_cuda_without_card_raises(digits, resnet_setup):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    imgs, labels = digits
    with pytest.raises(RuntimeError, match="cuda"):
        P.qat_finetune(imgs, labels)
    x, y, flat = resnet_setup
    with pytest.raises(RuntimeError, match="cuda"):
        P.qat_finetune_resnet(flat, x, y, stages=TINY)
