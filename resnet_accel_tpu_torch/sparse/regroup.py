"""Exact block-size regrouping: a BSR matrix repacked at a larger block.

A numpy copy of ``resnet_accel_tpu/sparse/regroup.py`` (``regroup_bsr``,
``effective_density``), kept here so the port imports nothing of the JAX
package; the tests hold it equal to the original.  It is the JAX
package's recipe for the reference's 14 x 14 exports: int8 x int8 ->
int32 is exact and zero blocks add exactly zero, so regrouping to the
tensor-core tile (128 x 128 there, K4's Hopper path here) and keeping
every superblock that holds a nonzero block gives bit-identical products;
only the skip's granularity changes.  ``chip_smoke.py`` times it against
K4's own small-block path on the sparse ResNet-18.
"""

from __future__ import annotations

import numpy as np

from resnet_accel_tpu_torch.sparse.bsr import BSRMatrix, build_bsr_int8_direct

#: The block the JAX package regroups to (its ``config.MXU_BLOCK``).
MXU_BLOCK: int = 128


def regroup_bsr(bsr: BSRMatrix, new_block_h: int = MXU_BLOCK,
                new_block_w: int = MXU_BLOCK) -> BSRMatrix:
    """Repack an int8 BSR matrix at a different block size (exact): the
    dense content is kept, superblocks that are wholly zero are dropped."""
    if bsr.data.dtype != np.int8:
        raise ValueError("regroup_bsr expects int8 blocks")
    dense = bsr.to_dense(padded=False)
    return build_bsr_int8_direct(dense, new_block_h, new_block_w)


def effective_density(bsr: BSRMatrix, block_h: int, block_w: int) -> float:
    """Fraction of (block_h x block_w) superblocks that would be nonzero:
    how much of the skip survives a regroup to that block."""
    dense = bsr.to_dense(padded=False)
    H = -(-dense.shape[0] // block_h) * block_h
    W = -(-dense.shape[1] // block_w) * block_w
    padded = np.zeros((H, W), dtype=dense.dtype)
    padded[:dense.shape[0], :dense.shape[1]] = dense
    t = padded.reshape(H // block_h, block_h, W // block_w, block_w)
    nz = np.any(t != 0, axis=(1, 3))
    return float(nz.mean()) if nz.size else 0.0
