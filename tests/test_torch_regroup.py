"""PyTorch port: ``sparse/regroup.py`` (``regroup_bsr``,
``effective_density``) against the JAX package's module, and the regrouped
weight's product against the original's.

The port keeps a numpy copy of the JAX module; both must give the same
BSR matrix (blocks, row pointers, columns) and the same density for the
same weights, and K4's product over the regrouped blocks must equal the
product over the original 14 x 14 blocks bit for bit (here through the
plain version, as on any CPU tensor).
"""

import numpy as np
import pytest
import torch

from resnet_accel_tpu import config as jconfig
from resnet_accel_tpu.sparse import bsr as jbsr
from resnet_accel_tpu.sparse import regroup as jregroup
from resnet_accel_tpu_torch import ops
from resnet_accel_tpu_torch.sparse import (MXU_BLOCK, build_bsr_int8_direct,
                                           effective_density, regroup_bsr)

torch.set_num_threads(2)


def _weight(rng, n, k, block, sparsity):
    W = rng.integers(-128, 128, (n, k)).astype(np.int8)
    keep = rng.random((-(-n // block), -(-k // block))) >= sparsity
    return W * np.repeat(np.repeat(keep, block, 0), block, 1)[:n, :k]


def test_mxu_block_is_the_jax_packages():
    assert MXU_BLOCK == jconfig.MXU_BLOCK


@pytest.mark.parametrize("n,k,sparsity,to", [
    (128, 576, 0.7, (128, 128)), (256, 1152, 0.9, (128, 128)),
    (70, 208, 0.5, (32, 64)), (131, 300, 1.0, (128, 128)),
    (64, 64, 0.0, (128, 128))])
def test_regroup_equals_jax(n, k, sparsity, to):
    rng = np.random.default_rng(n + k)
    W = _weight(rng, n, k, 14, sparsity)
    got = regroup_bsr(build_bsr_int8_direct(W, 14), *to)
    want = jregroup.regroup_bsr(jbsr.build_bsr_int8_direct(W, 14), *to)
    for f in ("data", "row_ptr", "col_idx"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (got.shape, got.block_h, got.block_w) == \
        (want.shape, want.block_h, want.block_w)
    got.validate()
    np.testing.assert_array_equal(got.to_dense(), W)
    for bh, bw in ((128, 128), (14, 128), to):
        assert effective_density(build_bsr_int8_direct(W, 14), bh, bw) == \
            jregroup.effective_density(jbsr.build_bsr_int8_direct(W, 14),
                                       bh, bw)


def test_regroup_refuses_float_blocks():
    bsr = build_bsr_int8_direct(np.ones((28, 28), np.int8), 14)
    bsr.data = bsr.data.astype(np.float32)
    with pytest.raises(ValueError):
        regroup_bsr(bsr)


def test_regrouped_product_is_bit_identical():
    """The JAX package's recipe on a 14 x 14 conv weight at 0.7: the
    regrouped 128 x 128 product equals the native one, though almost no
    128 x 128 superblock is empty."""
    rng = np.random.default_rng(3)
    W = _weight(rng, 128, 1152, 14, 0.7)
    bsr14 = build_bsr_int8_direct(W, 14)
    bsr128 = regroup_bsr(bsr14)
    assert effective_density(bsr14, 128, 128) > 0.9
    a = torch.from_numpy(rng.integers(-128, 128, (300, 1152)).astype(
        np.int8))
    want = ops.bsr_matmul_wt(a, ops.pack_bsr(bsr14, "cpu"))
    assert torch.equal(ops.bsr_matmul_wt(a, ops.pack_bsr(bsr128, "cpu")),
                       want)
    assert torch.equal(want.to(torch.int64), a.to(torch.int64)
                       @ torch.from_numpy(W).to(torch.int64).t())
