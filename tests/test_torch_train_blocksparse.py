"""PyTorch port: block pruning (``train/blocksparse.py``) against the JAX
package's.

Tolerances, each with its reason:
- 0 (exact) for the ranking, the masks, ``expand_mask``, the sparsities
  and ``progressive_prune`` with the same fine-tune: the same numpy code
  on the same inputs; and for ``make_mask_fn``: a product by 0 or 1.
- The group lasso: value rtol 1e-6 (a float32 sum over a few hundred
  block norms, summed in another order); gradient rtol 1e-5 with atol 1e-7
  relative to its largest entry (each entry is w / norm of its block, one
  float32 root and divide apart).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from resnet_accel_tpu.train import blocksparse as J
from resnet_accel_tpu_torch.train import blocksparse as P

torch.set_num_threads(2)


def _params(seed):
    """Layers of mixed shapes: a conv weight [O, I, kH, kW] whose flattening
    is not a multiple of the blocks, an fc weight and a small fc."""
    rng = np.random.default_rng(seed)
    return {
        "conv": rng.normal(0, 0.1, (48, 20, 3, 3)).astype(np.float32),
        "fc": rng.normal(0, 0.05, (64, 200)).astype(np.float32),
        "head": rng.normal(0, 0.3, (10, 64)).astype(np.float32),
    }


CFGS = {
    "uniform": {"conv": J.BlockCfg(8, 8, 0.3), "fc": J.BlockCfg(8, 8, 0.05),
                "head": J.BlockCfg(8, 8, 0.05)},
    "mixed": {"conv": J.BlockCfg(16, 16, 0.3), "fc": J.BlockCfg(32, 32, 0.05),
              "head": J.BlockCfg(4, 4, 0.5)},
}


def _port_cfgs(cfgs):
    return {k: P.BlockCfg(c.block_h, c.block_w, c.min_keep)
            for k, c in cfgs.items()}


def test_block_cfgs_equal():
    for name in ("DEFAULT_FC_CFG", "DEFAULT_CONV_CFG", "REF_FC_CFG",
                 "REF_CONV_CFG"):
        p, j = getattr(P, name), getattr(J, name)
        assert ((p.block_h, p.block_w, p.min_keep)
                == (j.block_h, j.block_w, j.min_keep)), name


@pytest.mark.parametrize("cfg", [(8, 8), (16, 32), (5, 7), (128, 128)])
@pytest.mark.parametrize("seed", [0, 1])
def test_compute_block_norms_and_expand_mask(cfg, seed):
    w = _params(seed)["conv"]
    jc, pc = J.BlockCfg(*cfg, 0.0), P.BlockCfg(*cfg, 0.0)
    jn, jg = J.compute_block_norms(w, jc)
    pn, pg = P.compute_block_norms(w, pc)
    assert jg == pg and np.array_equal(jn, pn)
    mask = np.random.default_rng(seed).random(jg) < 0.5
    assert np.array_equal(J.expand_mask(mask, jc, w.shape),
                          P.expand_mask(mask, pc, w.shape))


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("by_params", [False, True])
@pytest.mark.parametrize("cfg_name", sorted(CFGS))
@pytest.mark.parametrize("target", [0.3, 0.7, 0.95])
def test_prune_blocks_global_equal(normalize, by_params, cfg_name, target):
    params = _params(2)
    cfgs = CFGS[cfg_name]
    want = J.prune_blocks_global(params, target, cfgs, normalize=normalize,
                                 by_params=by_params)
    got = P.prune_blocks_global(params, target, _port_cfgs(cfgs),
                                normalize=normalize, by_params=by_params)
    assert list(got) == list(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    shapes = {k: params[k].shape for k in cfgs}
    assert P.sparsity_of_masks(got) == J.sparsity_of_masks(want)
    assert (P.effective_sparsity(got, _port_cfgs(cfgs), shapes)
            == J.effective_sparsity(want, cfgs, shapes))


def test_prune_ties_equal():
    """All-equal block norms: the stable sort keeps the layer order, so
    both packages prune the same blocks."""
    params = {"a": np.ones((16, 16), np.float32),
              "b": np.ones((16, 24), np.float32)}
    cfgs = {"a": J.BlockCfg(4, 4, 0.0), "b": J.BlockCfg(4, 4, 0.2)}
    want = J.prune_blocks_global(params, 0.5, cfgs)
    got = P.prune_blocks_global(params, 0.5, _port_cfgs(cfgs))
    for k in want:
        assert np.array_equal(got[k], want[k])


# The JAX package's own checks (tests/test_train.py::TestPruning), on the
# port.

def test_block_norms_shape():
    w = np.ones((16, 100), np.float32)
    norms, (nbr, nbc) = P.compute_block_norms(w, P.BlockCfg(8, 8, 0.0))
    assert (nbr, nbc) == (2, 13)
    assert abs(norms[0, 0] - 8.0) < 1e-6
    assert norms[0, 12] < norms[0, 0]


def test_global_ranking_and_keep_floor():
    params = {"a": np.full((8, 8), 10.0, np.float32),
              "b": np.full((8, 8), 0.1, np.float32)}
    masks = P.prune_blocks_global(params, 0.5,
                                  {k: P.BlockCfg(4, 4, 0.0) for k in params})
    assert masks["a"].all() and not masks["b"].any()
    masks = P.prune_blocks_global(
        params, 0.9, {"a": P.BlockCfg(4, 4, 0.0), "b": P.BlockCfg(4, 4, 0.5)})
    assert masks["b"].sum() >= 2


@pytest.mark.parametrize("target", [0.5, 0.9])
def test_target_and_by_params(target):
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(128, 256)).astype(np.float32)}
    masks = P.prune_blocks_global(params, target, {"w": P.BlockCfg(8, 8, 0)})
    assert abs(P.sparsity_of_masks(masks) - target) < 0.02
    rng = np.random.default_rng(3)
    params = {"big": rng.normal(size=(128, 128)).astype(np.float32),
              "small": rng.normal(size=(32, 32)).astype(np.float32)}
    cfgs = {"big": P.BlockCfg(32, 32, 0.0), "small": P.BlockCfg(8, 8, 0.0)}
    masks = P.prune_blocks_global(params, target, cfgs, normalize=True,
                                  by_params=True)
    shapes = {k: v.shape for k, v in params.items()}
    assert abs(P.effective_sparsity(masks, cfgs, shapes) - target) < 0.03


def test_effective_sparsity_weights_by_elements():
    cfgs = {"big": P.BlockCfg(32, 32, 0.0), "small": P.BlockCfg(8, 8, 0.0)}
    shapes = {"big": (32, 32), "small": (8, 8)}
    masks = {"big": np.zeros((1, 1), bool), "small": np.ones((1, 1), bool)}
    assert P.sparsity_of_masks(masks) == 0.5
    assert abs(P.effective_sparsity(masks, cfgs, shapes)
               - 1024 / (1024 + 64)) < 1e-6


def test_mask_fn_equal_to_jax():
    params = _params(4)
    cfgs = CFGS["mixed"]
    masks = J.prune_blocks_global(params, 0.6, cfgs)
    shapes = {k: params[k].shape for k in cfgs}
    want = J.make_mask_fn(masks, cfgs, shapes)(
        {k: jnp.asarray(v) for k, v in params.items()})
    fn = P.make_mask_fn(masks, _port_cfgs(cfgs), shapes)
    got = fn({k: torch.from_numpy(v) for k, v in params.items()})
    for k in params:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    assert np.array_equal(P.apply_mask_fn(fn, params)["fc"],
                          np.asarray(want["fc"]))
    # the JAX check: the masked blocks are zero, the others not
    m = {"w": np.array([[True, False], [False, True]])}
    w = np.random.default_rng(1).normal(size=(16, 16)).astype(np.float32)
    out = P.make_mask_fn(m, {"w": P.BlockCfg(8, 8, 0.0)}, {"w": (16, 16)})(
        {"w": torch.from_numpy(w)})["w"].numpy()
    assert np.all(out[:8, 8:] == 0) and np.all(out[8:, :8] == 0)
    assert np.any(out[:8, :8] != 0)


@pytest.mark.parametrize("cfg_name", sorted(CFGS))
def test_group_lasso_value_and_gradient(cfg_name):
    params = _params(5)
    params["fc"][:32, :32] = 0.0           # a zero block: the 1e-12 guard
    cfgs = CFGS[cfg_name]
    jfn = J.make_group_lasso_fn(cfgs, weight=1e-3)
    jval, jgrad = jax.value_and_grad(jfn)(
        {k: jnp.asarray(v) for k, v in params.items()})
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    val = P.make_group_lasso_fn(_port_cfgs(cfgs), weight=1e-3)(tp)
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-6)
    for k in cfgs:
        g, jg = tp[k].grad.numpy(), np.asarray(jgrad[k])
        assert np.all(np.isfinite(g))
        np.testing.assert_allclose(g, jg, rtol=1e-5,
                                   atol=1e-7 * np.abs(jg).max())
    assert float(val.detach()) > 0


def test_progressive_prune_equal():
    """The same fine-tune in both packages (a deterministic nudge through
    each package's own mask and lasso): equal params and masks at every
    level of the schedule."""
    params = _params(6)
    cfgs = CFGS["uniform"]

    def finetune(numpy_of, to_pkg):
        def run(p, mask_fn, reg_fn):
            q = to_pkg({k: v * np.float32(1.01) + np.float32(0.003)
                        for k, v in p.items()})
            assert float(reg_fn(q)) > 0
            return {k: numpy_of(v) for k, v in mask_fn(q).items()}
        return run

    want_p, want_m = J.progressive_prune(
        params, finetune(np.asarray,
                         lambda d: {k: jnp.asarray(v) for k, v in d.items()}),
        cfgs, schedule=[0.4, 0.6, 0.8])
    got_p, got_m = P.progressive_prune(
        params, finetune(lambda t: t.numpy(),
                         lambda d: {k: torch.from_numpy(v)
                                    for k, v in d.items()}),
        _port_cfgs(cfgs), schedule=[0.4, 0.6, 0.8])
    for k in want_m:
        assert np.array_equal(got_m[k], want_m[k]), k
    for k in want_p:
        assert np.array_equal(got_p[k], want_p[k]), k
    assert abs(J.sparsity_of_masks(want_m) - 0.8) < 0.02
