"""PyTorch port: ResNet training (``train/resnet18.py``) against the JAX
package's trainer, and its handoff to the quantizer and the int8 forward.

Tolerances, each with its reason:
- 0 (exact) for ``split_params`` and ``merge_params`` (numpy), for the max
  pool's values (a maximum is exact), and for the int8 forward of a trained
  model against the numpy golden ``forward_golden`` (integer-exact).
- Forward: logits rtol 1e-5, atol 1e-5; loss rtol 1e-5 (float32
  convolutions summed in another order than XLA's); the BatchNorm running
  statistics rtol 1e-5, atol 1e-6 (a batch mean near 0 of activations of
  order 1 is a difference of large sums: up to 5e-7 apart after 3 steps).
- Gradients against ``jax.grad``: rtol 1e-4 with atol 1e-5 relative to
  each gradient's largest entry, ten times the suggested start: in
  training mode BatchNorm's backward subtracts the batch means of the
  gradient, so small entries are differences of large ones (they agree to
  about 4e-6 of the largest entry through ResNet-18's depth).
- SGD trajectories (3 steps): the loss history rtol 1e-4; parameters
  elementwise atol 1e-5 + rtol 1e-4 (SGD adds lr times the gradient: the
  gradients' differences, scaled by lr); running statistics the same,
  since they follow parameters that far apart (5.5e-6 at worst).
- Masked weights: exactly 0.

The JAX training forward's 3x3/s2 max pool (``train/resnet18.py:95-104``)
raises where the stem's output height or width is even, as at 224 x 224
(its slices take H // 2 + 1 rows, the pool has H / 2): the ImageNet-stem
comparisons here use 34 x 34 inputs (a 17 x 17 stem output), and the port's
pool is held to ``F.max_pool2d`` at even sizes.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
import optax

from resnet_accel_tpu.models import resnet18 as JM
from resnet_accel_tpu.train import blocksparse as JB
from resnet_accel_tpu.train import resnet18 as J
from resnet_accel_tpu_torch.models import resnet18 as PM
from resnet_accel_tpu_torch.train import blocksparse as PB
from resnet_accel_tpu_torch.train import resnet18 as P

torch.set_num_threads(2)

TINY = [(8, 1, 1), (16, 1, 2)]
CPU = torch.device("cpu")


def tiny_data(n=64, classes=4, seed=0, hw=32):
    """tests/test_train_resnet18.py's class-dependent patch data."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, n)
    x = rng.normal(0, 0.3, (n, 3, hw, hw)).astype(np.float32)
    h = hw // 2
    for i in range(n):
        c = y[i]
        x[i, c % 3, (c // 3) * h:(c // 3) * h + h, :h] += 2.0
    return x, y


def close_grads(got, want, rel_atol=1e-5, rtol=1e-4):
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k], w, rtol=rtol,
                                   atol=rel_atol * np.abs(w).max(),
                                   err_msg=k)


def test_split_merge_identical():
    flat = JM.init_resnet18_fp32(seed=2, num_classes=10, small_input=True)
    jt, js = J.split_params(flat)
    pt, ps = P.split_params(flat)
    for a, b in ((jt, pt), (js, ps)):
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    m, jm = P.merge_params(pt, ps), J.merge_params(jt, js)
    assert list(m) == list(jm)
    assert all(np.array_equal(m[k], jm[k]) for k in m)


# (small_input, hw, stages, bottleneck): CIFAR and ImageNet stems, the
# basic and the bottleneck plan.
FORWARDS = {
    "cifar-basic": (True, 16, TINY, False),
    "imagenet-basic": (False, 34, TINY, False),
    "cifar-bottleneck": (True, 16, TINY, True),
    "imagenet-resnet18": (False, 33, None, False),
}


@pytest.mark.parametrize("name", sorted(FORWARDS))
def test_forward_gradients_and_bn_updates(name):
    small, hw, stages, bott = FORWARDS[name]
    flat = PM.init_resnet18_fp32(seed=1, num_classes=5, small_input=small,
                                 stages=stages, bottleneck=bott)
    p, s = P.split_params(flat)
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (4, 3, hw, hw)).astype(np.float32)
    y = rng.integers(0, 5, 4)
    js = {k: jnp.asarray(v) for k, v in s.items()}
    for training in (True, False):
        def jloss(pp):
            lg, u = J.resnet18_forward(pp, js, jnp.asarray(x), small,
                                       training, stages=stages,
                                       bottleneck=bott)
            return optax.softmax_cross_entropy_with_integer_labels(
                lg, jnp.asarray(y)).mean(), (lg, u)

        (jl, (jlg, ju)), jg = jax.jit(jax.value_and_grad(
            jloss, has_aux=True))({k: jnp.asarray(v) for k, v in p.items()})
        tp = P.to_device(p, CPU)
        ts = {k: torch.from_numpy(v) for k, v in s.items()}
        lg, u = P.resnet18_forward(tp, ts, torch.from_numpy(x), small,
                                   training, stages=stages, bottleneck=bott)
        loss = F.cross_entropy(lg, torch.from_numpy(y))
        loss.backward()
        np.testing.assert_allclose(lg.detach().numpy(), np.asarray(jlg),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(loss.detach()), float(jl),
                                   rtol=1e-5)
        close_grads({k: v.grad.numpy() for k, v in tp.items()}, jg)
        assert sorted(u) == sorted(ju) and (len(u) > 0) == training
        for k in ju:
            np.testing.assert_allclose(u[k].numpy(), np.asarray(ju[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


def test_running_var_is_biased():
    """The running variance moves by the biased batch variance, as
    jnp.var's; nn.BatchNorm2d would take the unbiased one."""
    flat = PM.init_resnet18_fp32(seed=3, num_classes=2, small_input=True,
                                 stages=TINY)
    p, s = P.split_params(flat)
    x = np.random.default_rng(1).normal(0, 1, (3, 3, 8, 8)).astype(
        np.float32)
    tp = P.to_device(p, CPU)
    _, u = P.resnet18_forward(tp, {k: torch.from_numpy(v)
                                   for k, v in s.items()},
                              torch.from_numpy(x), True, True, stages=TINY)
    a = F.conv2d(torch.from_numpy(x), tp["conv1.weight"], padding=1)
    a = a.detach().double().numpy()
    biased, unbiased = a.var(axis=(0, 2, 3)), a.var(axis=(0, 2, 3), ddof=1)
    rv = s["bn1.running_var"].astype(np.float64)
    np.testing.assert_allclose(u["bn1.running_var"].numpy(),
                               0.9 * rv + 0.1 * biased, rtol=1e-5)
    assert not np.allclose(u["bn1.running_var"].numpy(),
                           0.9 * rv + 0.1 * unbiased, rtol=1e-5)
    np.testing.assert_allclose(u["bn1.running_mean"].numpy(),
                               0.9 * s["bn1.running_mean"]
                               + 0.1 * a.mean(axis=(0, 2, 3)),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("hw", [5, 8, 17, 112])
def test_max_pool_values_and_tie_gradients(hw):
    """Values: F.max_pool2d's at every size.  Gradients at ties (the
    zeros after ReLU): the JAX slice-max chain's where it runs (odd
    sizes)."""
    rng = np.random.default_rng(hw)
    a = np.maximum(rng.normal(0, 1, (2, 3, hw, hw)), 0).astype(np.float32)
    a[:, :, :2, :2] = 1.0                             # equal maxima
    t = torch.tensor(a, requires_grad=True)
    out = P.max_pool_3x3_s2(t)
    assert torch.equal(out, F.max_pool2d(torch.from_numpy(a), 3, 2, 1))
    if hw % 2 == 0:
        return
    w = rng.normal(0, 1, out.shape).astype(np.float32)
    (out * torch.from_numpy(w)).sum().backward()

    def jpool(v):
        H, W = v.shape[2:]
        ap = jnp.pad(v, ((0, 0), (0, 0), (1, 1), (1, 1)),
                     constant_values=-jnp.inf)
        sl = [ap[:, :, i:i + 2 * (H // 2) + 1:2, j:j + 2 * (W // 2) + 1:2]
              for i in range(3) for j in range(3)]
        m = sl[0]
        for s in sl[1:]:
            m = jnp.maximum(m, s)
        return (m * w).sum()

    jg = jax.grad(jpool)(jnp.asarray(a))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-7)


def _trajectories(x, y, **kw):
    want = J.train_resnet18(x, y, **kw)
    got = P.train_resnet18(x, y, device="cpu", **kw)
    for g, w in zip(got.history, want.history):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
        assert abs(g["train_acc"] - w["train_acc"]) <= 1 / 16
    for k in want.params:
        np.testing.assert_allclose(got.params[k],
                                   np.asarray(want.params[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    for k in want.bn_state:
        np.testing.assert_allclose(got.bn_state[k],
                                   np.asarray(want.bn_state[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    return got, want


@pytest.mark.parametrize("bottleneck", [False, True])
def test_sgd_trajectory(bottleneck):
    x, y = tiny_data(48, 4, hw=16)
    _trajectories(x, y, epochs=1, batch_size=16, lr=0.05, num_classes=4,
                  seed=0, small_input=True, stages=TINY,
                  bottleneck=bottleneck)


def test_masked_trajectory_and_lasso():
    """tests/test_train_resnet18.py's mask check, with the group lasso in
    the loss, against the JAX trainer."""
    x, y = tiny_data(32, 2, hw=16)
    flat = PM.init_resnet18_fp32(seed=0, num_classes=2, small_input=True,
                                 stages=TINY)
    key = "layer2.0.conv1.weight"
    jcfg = {key: JB.BlockCfg(8, 8, 0.0)}
    pcfg = {key: PB.BlockCfg(8, 8, 0.0)}
    masks = JB.prune_blocks_global(flat, 0.5, jcfg)
    shapes = {key: flat[key].shape}
    want = J.train_resnet18(x, y, epochs=1, batch_size=16, num_classes=2,
                            seed=0, init=flat, stages=TINY,
                            mask_fn=JB.make_mask_fn(masks, jcfg, shapes),
                            reg_fn=JB.make_group_lasso_fn(jcfg, 1e-3))
    got = P.train_resnet18(x, y, epochs=1, batch_size=16, num_classes=2,
                           seed=0, init=flat, stages=TINY,
                           mask_fn=PB.make_mask_fn(masks, pcfg, shapes),
                           reg_fn=PB.make_group_lasso_fn(pcfg, 1e-3),
                           device="cpu")
    np.testing.assert_allclose(got.history[0]["loss"],
                               want.history[0]["loss"], rtol=1e-4)
    m = PB.expand_mask(masks[key], pcfg[key], shapes[key])
    w = got.params[key]
    assert np.all(w[m == 0] == 0) and np.any(w[m == 1] != 0)
    np.testing.assert_allclose(w, np.asarray(want.params[key]), rtol=1e-4,
                               atol=1e-5)


def test_trained_model_quantizes_and_serves():
    """tests/test_train_resnet18.py: a trained ResNet-18 quantizes, its int8
    forward equals the golden bit for bit, and its predictions follow the
    float model's; here trained by the port, served by the port's module."""
    x, y = tiny_data(32, 4)
    st = P.train_resnet18(x, y, epochs=2, batch_size=16, num_classes=4,
                          seed=1, device="cpu")
    flat = P.export_inference_params(st)
    assert sorted(flat) == sorted(PM.init_resnet18_fp32(
        seed=0, num_classes=4, small_input=True))
    jmodel = JM.quantize_resnet18(flat, x[:4], 4, small_input=True)
    mod = PM.ResNet18Int8Module(PM.from_reference(jmodel), "cpu")
    with torch.inference_mode():
        out = mod(torch.from_numpy(x[:16])).numpy()
    np.testing.assert_array_equal(out[:4], JM.forward_golden(jmodel, x[:4]))
    pmodel = PM.quantize_resnet18(flat, x[:4], 4, small_input=True)
    for (name, a), (_, b) in zip(jmodel.named_convs(), pmodel.named_convs()):
        np.testing.assert_array_equal(a.w2d, b.w2d, err_msg=name)
        np.testing.assert_allclose(b.factors, a.factors, rtol=1e-5)
    with torch.no_grad():
        logits, _ = P.resnet18_forward(
            P.to_device(st.params, CPU),
            {k: torch.from_numpy(v) for k, v in st.bn_state.items()},
            torch.from_numpy(x[:16]), True, False)
    assert (logits.argmax(-1).numpy() == out.argmax(-1)).mean() >= 0.75


def test_bottleneck_plan_end_to_end():
    """The family trainer: a tiny bottleneck plan trains, exports and
    quantizes as the JAX package's does, and serves on the port."""
    rng = np.random.default_rng(7)
    stages = [(8, 1, 1), (16, 1, 2)]
    x = rng.normal(0, 1, (32, 3, 32, 32)).astype(np.float32)
    y = (x[:, 0, :8, :8].mean(axis=(1, 2)) > 0).astype(np.int64)
    st = P.train_resnet18(x, y, epochs=1, batch_size=16, num_classes=2,
                          small_input=True, stages=stages, bottleneck=True,
                          device="cpu")
    assert np.isfinite(st.history[-1]["loss"])
    flat = P.export_inference_params(st)
    assert "layer1.0.conv3.weight" in flat
    kw = dict(small_input=True, stages=stages, bottleneck=True)
    pmodel = PM.quantize_resnet18(flat, x[:4], 2, **kw)
    jmodel = JM.quantize_resnet18(flat, x[:4], 2, **kw)
    for (name, a), (_, b) in zip(jmodel.named_convs(), pmodel.named_convs()):
        np.testing.assert_array_equal(a.w2d, b.w2d, err_msg=name)
    with torch.inference_mode():
        out = PM.ResNet18Int8Module(pmodel, "cpu")(torch.from_numpy(x[:2]))
    assert out.shape == (2, 2) and torch.isfinite(out).all()


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    x, y = tiny_data(16, 2, hw=8)
    with pytest.raises(RuntimeError, match="cuda"):
        P.train_resnet18(x, y, stages=TINY)
