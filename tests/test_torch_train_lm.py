"""PyTorch port: the decoder-LM pipeline (``train/lm.py``: train fp32 ->
block-prune -> INT8 -> serve) against the JAX package's, at
``tests/test_train_lm.py``'s size (vocab 16, d_model 64, 4 heads, d_ff 128,
one layer, max_len 32).

Tolerances, each with its reason:
- 0 (exact) for ``init_lm_fp32``, ``cyclic_sequences``,
  ``prune_lm_blockwise`` and ``quantize_lm``'s arrays against the JAX
  results carried over by ``from_reference`` (the same numpy code), and
  for greedy tokens.
- Forward: logits rtol 1e-5, atol 1e-5, loss rtol 1e-5 (float32 products,
  softmax and LayerNorm in another order than XLA's, and torch's tanh GELU
  against jax.nn.gelu's).
- Gradients against ``jax.grad``: rtol 1e-4 with atol 1e-6 relative to
  each gradient's largest entry (the suggested start); for the key bias
  ``wk_b``, 1e-6 of the largest entry of any gradient: its exact gradient
  is 0 (a query's scores all shift by the same q . b, which the softmax
  cancels), so both packages return rounding noise of about 1e-8.
- Trajectory (Adam, 5 steps): the loss history rtol 1e-4; each parameter
  by the share of its elements within atol 1e-5 + rtol 1e-4 (at least
  0.999; the worst printed), none beyond 8 lr a step (Adam, as in
  tests/test_torch_train_mnist.py).  ``wk_b`` only by that bound: Adam
  turns its noise gradient into steps of about lr, of a sign that is the
  noise's, in either package.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
import optax

from resnet_accel_tpu.train import lm as J
from resnet_accel_tpu_torch.models.lm import from_reference
from resnet_accel_tpu_torch.models.transformer import PROJECTIONS
from resnet_accel_tpu_torch.train import lm as P
from resnet_accel_tpu_torch.train.mnist import to_device

torch.set_num_threads(2)

VOCAB, D, HEADS, LAYERS = 16, 64, 4, 1
CFG = dict(vocab=VOCAB, d_model=D, n_heads=HEADS, d_ff=128, n_layers=LAYERS,
           max_len=32)
CPU = torch.device("cpu")


def _tensors(p):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in p.items()
            if k != "meta"}


@pytest.fixture(scope="module")
def trained():
    """tests/test_train_lm.py's trained model, on the port."""
    p = P.init_lm_fp32(**CFG, seed=0)
    return P.train_lm(p, LAYERS, HEADS, VOCAB, seq_len=12, steps=250,
                      batch=16, seed=0, device="cpu")


@pytest.mark.parametrize("seed", [0, 3])
def test_init_and_sequences_identical(seed):
    kw = dict(CFG, n_layers=2)
    a, b = P.init_lm_fp32(**kw, seed=seed), J.init_lm_fp32(**kw, seed=seed)
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    for args in ((VOCAB, 12, 5), (256, 40, 3)):
        assert np.array_equal(P.cyclic_sequences(*args, seed=seed),
                              J.cyclic_sequences(*args, seed=seed))
    assert np.array_equal(P.cyclic_sequences(32, 9, 4, seed, a=5, b=3),
                          J.cyclic_sequences(32, 9, 4, seed, a=5, b=3))


@pytest.mark.parametrize("layers", [1, 2])
def test_forward_and_gradients(layers):
    """The batched forward against JAX's vmap of its one-sequence
    forward; loss and every gradient against jax.grad."""
    p = J.init_lm_fp32(**dict(CFG, n_layers=layers), seed=1)
    toks = J.cyclic_sequences(VOCAB, 12, 4, seed=2)
    keys = [k for k in p if k not in ("meta", "pos")]

    def jloss(tp):
        full = {k: jnp.asarray(v) for k, v in p.items() if k != "meta"}
        full.update(tp)
        logits = jax.vmap(lambda t: J.lm_forward_fp32(
            full, t, layers, HEADS))(jnp.asarray(toks))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1], jnp.asarray(toks)[:, 1:]).mean(), logits

    (jl, jlg), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        {k: jnp.asarray(p[k]) for k in keys})
    tp = to_device(p, CPU, keys)
    full = dict(tp, pos=torch.from_numpy(p["pos"]))
    t = torch.from_numpy(toks).long()
    logits = P.lm_forward_fp32(full, t, layers, HEADS)
    loss = F.cross_entropy(logits[:, :-1].reshape(-1, VOCAB),
                           t[:, 1:].reshape(-1))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlg),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    top = max(float(np.abs(np.asarray(g)).max()) for g in jg.values())
    for k in keys:
        w = np.asarray(jg[k])
        scale = top if k.endswith(".wk_b") else np.abs(w).max()
        np.testing.assert_allclose(tp[k].grad.numpy(), w, rtol=1e-4,
                                   atol=1e-6 * scale, err_msg=k)
    # one sequence, as JAX's forward takes it
    with torch.no_grad():
        one = P.lm_forward_fp32(full, t[0], layers, HEADS)
    np.testing.assert_allclose(one.numpy(), np.asarray(jlg[0]), rtol=1e-5,
                               atol=1e-5)


def test_trajectory():
    p = J.init_lm_fp32(**CFG, seed=0)
    lr = 3e-3
    got, ghist = P.train_lm(p, LAYERS, HEADS, VOCAB, seq_len=12, steps=5,
                            batch=16, lr=lr, seed=4, device="cpu")
    want, jhist = J.train_lm(p, LAYERS, HEADS, VOCAB, seq_len=12, steps=5,
                             batch=16, lr=lr, seed=4)
    np.testing.assert_allclose(ghist, jhist, rtol=1e-4)
    assert list(got) == list(want)
    for k in ("pos", "meta"):
        assert np.array_equal(got[k], p[k])
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        d = np.abs(a - b)
        ok = float(np.mean(d <= 1e-5 + 1e-4 * np.abs(b)))
        worst = np.unravel_index(int(np.argmax(d)), d.shape)
        print(f"{k}: {ok:.6f} of {d.size} within tolerance; worst "
              f"{worst}: port {a[worst]!r} jax {b[worst]!r}")
        assert d.max() <= 8 * lr * 5, k
        if not k.endswith(".wk_b"):
            assert ok >= 0.999, k


# tests/test_train_lm.py's end-to-end checks, on the port

def test_loss_decreases_and_learns(trained):
    p, hist = trained
    assert np.mean(hist[-20:]) < 0.5 * np.mean(hist[:20])
    toks = P.cyclic_sequences(VOCAB, 12, 1, seed=123)[0]
    with torch.no_grad():
        logits = P.lm_forward_fp32(_tensors(p), torch.from_numpy(toks).long(),
                                   LAYERS, HEADS).numpy()
    assert float((logits[:-1].argmax(-1) == toks[1:]).mean()) >= 0.8


@pytest.mark.parametrize("sparsity", [0.2, 0.3, 0.8])
@pytest.mark.parametrize("block", [8, 16])
def test_prune_identical(trained, sparsity, block):
    p, _ = trained
    a = P.prune_lm_blockwise(p, sparsity, block)
    b = J.prune_lm_blockwise(p, sparsity, block)
    assert list(a) == list(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


def test_uniform_norms_prune_exact_quota():
    """All block norms equal: argsort prunes exactly the quota, in both
    packages the same blocks."""
    p = P.init_lm_fp32(**dict(CFG, max_len=8), seed=1)
    for name in PROJECTIONS:
        p[f"b0.{name}"] = np.ones_like(p[f"b0.{name}"])
    out = P.prune_lm_blockwise(p, sparsity=0.25, block=8)
    t = out["b0.wq"].reshape(D // 8, 8, D // 8, 8)
    assert int((np.abs(t).sum(axis=(1, 3)) == 0).sum()) == \
        int((D // 8) ** 2 * 0.25)
    ref = J.prune_lm_blockwise(p, sparsity=0.25, block=8)
    for k in out:
        assert np.array_equal(out[k], ref[k]), k


def test_quantize_equals_jax_and_serves(trained):
    """quantize_lm's arrays equal JAX's carried over; the pruned int8 model
    keeps the cycle (tests/test_train_lm.py's accuracy and generate)."""
    p, _ = trained
    pruned = P.prune_lm_blockwise(p, sparsity=0.3, block=8)
    lm = P.quantize_lm(pruned, HEADS, block=8)
    ref = from_reference(J.quantize_lm(pruned, HEADS, block=8))
    for f in ("embed", "pos", "lnf_g", "lnf_b"):
        assert np.array_equal(getattr(lm, f), getattr(ref, f)), f
    for a, b in zip(lm.blocks, ref.blocks):
        assert a.n_heads == b.n_heads
        for name in PROJECTIONS:
            pa, pb = getattr(a, name), getattr(b, name)
            for g in ("data", "row_ptr", "col_idx"):
                assert np.array_equal(getattr(pa.bsr, g),
                                      getattr(pb.bsr, g)), (name, g)
            assert np.array_equal(pa.scales, pb.scales)
            assert np.array_equal(pa.bias, pb.bias)
    assert all(s >= 0.25 for s in lm.blocks[0].sparsity_report().values())
    toks = P.cyclic_sequences(VOCAB, 12, 1, seed=321)[0]
    scales = lm.calibrate(toks)
    with torch.inference_mode():
        logits = lm.module("cpu").forward(toks, scales).numpy()
    assert float((logits[:-1].argmax(-1) == toks[1:]).mean()) >= 0.7

    lm = P.quantize_lm(P.prune_lm_blockwise(p, 0.2, 8), HEADS, 8)
    toks = P.cyclic_sequences(VOCAB, 8, 1, seed=7)[0]
    scales = lm.calibrate(toks)
    with torch.inference_mode():
        out = np.asarray(lm.generate(toks[:6], 4, scales, device="cpu"))
        flash = np.asarray(lm.generate(toks[:6], 4, scales, device="cpu",
                                       flash=True))
    assert np.array_equal(out, flash)
    want = [(3 * t + 1) % VOCAB
            for t in np.concatenate([toks[5:6], out[:-1]])]
    assert (out == np.asarray(want)).mean() >= 0.5


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = P.init_lm_fp32(**CFG, seed=0)
    with pytest.raises(RuntimeError, match="cuda"):
        P.train_lm(p, LAYERS, HEADS, VOCAB, steps=1)
