"""PyTorch port: MNIST CNN training (``train/mnist.py``), the npz
checkpoints (``train/checkpoint.py``) and the IDX loader copy
(``utils/mnist_data.py``) against the JAX package's, on a seeded synthetic
split (the real MNIST files are not in the repository).

Tolerances, each with its reason:
- 0 (exact) for the IDX loader, ``init_mnist_params``, the checkpoint
  files' arrays and the golden inputs: the same numpy code.
- Forward: logits rtol 1e-5, atol 1e-5, loss rtol 1e-5 (float32
  convolutions and fc1's 9216-term products summed in another order than
  XLA's: logits up to about 5 differ by up to 1.5e-6).
- Gradients against ``jax.grad``: rtol 1e-4 with atol 1e-6 relative to
  each gradient's largest entry (the suggested start; they agree to about
  1.3e-6 of the largest entry at worst, conv1's).
- Trajectories (Adam, 4 steps): the loss history rtol 1e-4; each
  parameter by the share of its elements within atol 1e-5 + rtol 1e-4
  (at least 0.999; the worst element printed), none beyond 8 lr a step:
  Adam divides by the root of the second moment, so an element whose
  gradient is near the rounding noise can move by about lr either way in
  either package.
- Masked weights: exactly 0.
"""

import gzip
import inspect
import json
import os
import struct

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from resnet_accel_tpu.train import checkpoint as j_checkpoint
from resnet_accel_tpu.train import mnist as J
from resnet_accel_tpu.train.blocksparse import BlockCfg as JBlockCfg
from resnet_accel_tpu.train.blocksparse import make_group_lasso_fn as j_lasso
from resnet_accel_tpu.train.blocksparse import make_mask_fn as j_mask_fn
from resnet_accel_tpu.train.blocksparse import (
    prune_blocks_global as j_prune)
from resnet_accel_tpu.utils import mnist_data as j_data
from resnet_accel_tpu_torch.train import checkpoint as p_checkpoint
from resnet_accel_tpu_torch.train import mnist as P
from resnet_accel_tpu_torch.train.blocksparse import (BlockCfg,
                                                      make_group_lasso_fn,
                                                      make_mask_fn)
from resnet_accel_tpu_torch.utils import mnist_data as p_data

torch.set_num_threads(2)

LR = 1e-3


def close_grads(got, want, rel_atol=1e-6, rtol=1e-4):
    for k in want:
        g, w = got[k], np.asarray(want[k])
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=rel_atol * np.abs(w).max(),
                                   err_msg=k)


def close_params(got, want, lr, steps, share=0.999):
    """Each parameter: the share of elements within atol 1e-5 + rtol 1e-4
    at least ``share``, none beyond 8 lr a step."""
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        d = np.abs(a - b)
        ok = float(np.mean(d <= 1e-5 + 1e-4 * np.abs(b)))
        worst = np.unravel_index(int(np.argmax(d)), d.shape)
        print(f"{k}: {ok:.6f} of {d.size} within tolerance; worst "
              f"{worst}: port {a[worst]!r} jax {b[worst]!r}")
        assert ok >= share, k
        assert d.max() <= 8 * lr * steps, k


@pytest.fixture(scope="module")
def digits():
    return p_data.synthetic_digits(80, seed=0)


class TestIdxLoader:
    def test_copy_equals_original(self):
        for name in ("_open", "load_idx_images", "load_idx_labels",
                     "load_mnist_split"):
            assert (inspect.getsource(getattr(p_data, name))
                    == inspect.getsource(getattr(j_data, name))), name

    @pytest.mark.parametrize("gz", [False, True])
    def test_reads_what_the_original_reads(self, tmp_path, gz):
        imgs, labels = p_data.synthetic_digits(37, seed=5)
        p_data.save_idx_split(str(tmp_path), imgs, labels)
        if gz:
            for f in os.listdir(tmp_path):
                path = os.path.join(tmp_path, f)
                with open(path, "rb") as fi, gzip.open(path + ".gz",
                                                       "wb") as fo:
                    fo.write(fi.read())
                os.remove(path)
        got = p_data.load_mnist_split(str(tmp_path))
        want = j_data.load_mnist_split(str(tmp_path))
        for g, w, ref in zip(got, want, (imgs, labels)):
            assert g.dtype == w.dtype and np.array_equal(g, w)
            assert np.array_equal(g, ref)

    def test_bad_magic_and_missing(self, tmp_path):
        p_data.save_idx_split(str(tmp_path), np.zeros((2, 28, 28)), [1, 2])
        img = tmp_path / "t10k-images-idx3-ubyte"
        data = img.read_bytes()
        img.write_bytes(struct.pack(">I", 2049) + data[4:])
        for mod in (p_data, j_data):
            with pytest.raises(ValueError, match="bad magic"):
                mod.load_idx_images(str(img))
            with pytest.raises(FileNotFoundError):
                mod.load_mnist_split(str(tmp_path), "train")


@pytest.mark.parametrize("seed", [0, 1917])
def test_init_identical(seed):
    a, b = P.init_mnist_params(seed), J.init_mnist_params(seed)
    assert list(a) == list(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("with_lasso", [False, True])
def test_forward_and_gradients(digits, with_lasso):
    imgs, labels = digits
    params = P.init_mnist_params(3)
    x = P.normalize_mnist(imgs[:16])
    y = labels[:16]
    jcfg = {"fc1.weight": JBlockCfg(128, 128, 0.05),
            "fc2.weight": JBlockCfg(8, 8, 0.05)}

    def jloss(pp):
        logits = J.mnist_forward_fp32(pp, jnp.asarray(x))
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean()
        if with_lasso:
            loss = loss + j_lasso(jcfg, 1e-3)(pp)
        return loss, logits

    (jl, jlogits), jg = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()})
    tp = P.to_device(params, torch.device("cpu"))
    logits = P.mnist_forward_fp32(tp, torch.from_numpy(x))
    loss = torch.nn.functional.cross_entropy(logits,
                                             torch.from_numpy(y).long())
    if with_lasso:
        loss = loss + make_group_lasso_fn(
            {k: BlockCfg(c.block_h, c.block_w, c.min_keep)
             for k, c in jcfg.items()}, 1e-3)(tp)
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    close_grads({k: v.grad.numpy() for k, v in tp.items()}, jg)


def test_relu_and_pool_ties_split_as_jax():
    """At exact ties ReLU gives half the gradient and the 2x2 pool splits
    it evenly, as jnp.maximum and jnp.max do."""
    v = np.array([[-1.0, 0.0, 2.0, 0.0]], np.float32)
    t = torch.tensor(v, requires_grad=True)
    P.relu(t).sum().backward()
    jg = jax.grad(lambda a: jnp.maximum(a, 0).sum())(jnp.asarray(v))
    assert np.array_equal(t.grad.numpy(), np.asarray(jg))
    a = np.zeros((1, 1, 2, 2), np.float32)
    a[0, 0, 0, 1] = a[0, 0, 1, 0] = 1.0
    t = torch.tensor(a, requires_grad=True)
    t.reshape(1, 1, 1, 2, 1, 2).amax(dim=(3, 5)).sum().backward()
    jg = jax.grad(lambda b: b.reshape(1, 1, 1, 2, 1, 2).max(
        axis=(3, 5)).sum())(jnp.asarray(a))
    assert np.array_equal(t.grad.numpy(), np.asarray(jg))


def test_trajectory(digits):
    imgs, labels = digits
    want = J.train_mnist(imgs, labels, epochs=2, batch_size=32, lr=LR,
                         seed=0)
    got = P.train_mnist(imgs, labels, epochs=2, batch_size=32, lr=LR,
                        seed=0, device="cpu")
    assert got.hparams == want.hparams and got.seed == want.seed
    for g, w in zip(got.history, want.history):
        assert g["epoch"] == w["epoch"]
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
        assert abs(g["eval_acc"] - w["eval_acc"]) <= 1 / 8
    close_params(got.params, want.params, LR, 4)
    assert got.history[-1]["loss"] < got.history[0]["loss"]


def test_masked_trajectory(digits):
    """Masks put back after every step and the group lasso in the loss:
    the same trajectory as JAX's, the masked weights exactly 0."""
    imgs, labels = digits
    params = J.init_mnist_params(0)
    jcfg = {"fc1.weight": JBlockCfg(128, 128, 0.05),
            "fc2.weight": JBlockCfg(8, 8, 0.05)}
    pcfg = {k: BlockCfg(c.block_h, c.block_w, c.min_keep)
            for k, c in jcfg.items()}
    masks = j_prune(params, 0.5, jcfg)
    shapes = {k: params[k].shape for k in jcfg}
    want = J.train_mnist(imgs, labels, epochs=1, batch_size=32, seed=0,
                         params=params,
                         mask_fn=j_mask_fn(masks, jcfg, shapes),
                         reg_fn=j_lasso(jcfg, 1e-4))
    got = P.train_mnist(imgs, labels, epochs=1, batch_size=32, seed=0,
                        params=params, mask_fn=make_mask_fn(masks, pcfg,
                                                            shapes),
                        reg_fn=make_group_lasso_fn(pcfg, 1e-4),
                        device="cpu")
    np.testing.assert_allclose(got.history[0]["loss"],
                               want.history[0]["loss"], rtol=1e-4)
    close_params(got.params, want.params, LR, 2)
    for k, m in masks.items():
        dense = np.repeat(np.repeat(m, jcfg[k].block_h, 0),
                          jcfg[k].block_w, 1)[:shapes[k][0], :shapes[k][1]]
        assert np.all(got.params[k][~dense] == 0), k
        assert np.any(got.params[k][dense] != 0), k


def test_checkpoint_and_golden_vectors(digits, tmp_path):
    imgs, labels = digits
    res = P.train_mnist(imgs, labels, epochs=1, batch_size=32, seed=0,
                        device="cpu")
    path = str(tmp_path / "ck" / "model.npz")
    P.save_checkpoint(res, path)
    for load in (P.load_checkpoint, J.load_checkpoint):
        loaded = load(path)
        assert list(loaded) == list(res.params)
        for k in loaded:
            assert np.array_equal(loaded[k], res.params[k])
    with open(path + ".meta.json") as f:
        meta = json.load(f)
    assert meta == {"seed": 0, "hparams": res.hparams,
                    "best_acc": res.best_acc, "history": res.history}
    P.export_golden_vectors(res, imgs, str(tmp_path / "gp"), num=8,
                            device="cpu")
    J.export_golden_vectors(res, imgs, str(tmp_path / "gj"), num=8)
    for name, tol in (("mnist_inputs.npy", 0), ("mnist_logits_fp32.npy",
                                                1e-5)):
        a = np.load(tmp_path / "gp" / name)
        b = np.load(tmp_path / "gj" / name)
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


def test_checkpoint_manager_layout(tmp_path, monkeypatch):
    """The npz layout of the JAX manager's no-orbax branch: each package
    restores the other's files; the port keeps the newest max_to_keep."""
    monkeypatch.setattr(j_checkpoint, "HAS_ORBAX", False)
    rng = np.random.default_rng(0)
    trees = {s: {"w": rng.normal(size=(3, 4)).astype(np.float32),
                 "step": np.asarray(s)} for s in (1, 2, 5, 7)}
    pm = p_checkpoint.CheckpointManager(str(tmp_path / "p"), max_to_keep=3)
    jm = j_checkpoint.CheckpointManager(str(tmp_path / "j"), max_to_keep=3)
    with pytest.raises(FileNotFoundError):
        pm.restore()
    for s, tree in trees.items():
        pm.save(s, {**tree, "w": torch.from_numpy(tree["w"])})
        jm.save(s, tree)
    assert sorted(os.listdir(tmp_path / "p")) == [
        "step_2.npz", "step_5.npz", "step_7.npz"]
    assert pm.latest_step() == jm.latest_step() == 7
    for s in (2, 5, 7):
        for m in (pm, jm):
            got = m.restore(s)
            for k, v in trees[s].items():
                assert np.array_equal(got[k], v)
    other = j_checkpoint.CheckpointManager(str(tmp_path / "p"))
    assert other.latest_step() == 7
    assert np.array_equal(other.restore()["w"], trees[7]["w"])
    back = p_checkpoint.CheckpointManager(str(tmp_path / "j"), 10)
    assert np.array_equal(back.restore(1)["w"], trees[1]["w"])


def test_cuda_without_card_raises(digits):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    imgs, labels = digits
    with pytest.raises(RuntimeError, match="cuda"):
        P.train_mnist(imgs, labels, epochs=1)
