"""Synthetic block-sparse fixtures: masks, weights and the fixture tree.

A numpy copy of ``resnet_accel_tpu/sparse/fixtures.py``, kept here so the
port imports nothing of the JAX package; the tests hold the copy equal to
its original, file for file.  Deterministic block-sparse weights at given
sparsities, quantized per channel and written in the fixture layout
(``sparse.io``), so ``load_layer_dir`` and the models read them:

- transformer: Q/K/V projections d_model=128, d_head=64 @ 80/90%, 8x8
- mlp: fc 512x128, 1024x256, 9216x128 @ 90%, 8x8
- conv: 1->32, 32->64, 64->128 k3 @ 50-75%, 4x4 on flattened weights

As in the original, the transformer weights are seeded with
``seed + hash(mat) % 97``; Python salts ``str`` hashes per process, so the
tree is reproducible within one process only.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

from resnet_accel_tpu_torch.quant import quantize_symmetric_per_channel
from resnet_accel_tpu_torch.sparse.bsr import build_bsr, conv_weight_to_2d
from resnet_accel_tpu_torch.sparse.io import save_layer_dir


def create_sparse_mask(
    shape: Tuple[int, int],
    block_size: int,
    sparsity: float,
    seed: int = 42,
) -> np.ndarray:
    """Block mask with exactly ``round(total * sparsity)`` of the
    ``block_size``-square blocks zeroed, chosen from ``seed``."""
    h, w = shape
    nbr, nbc = -(-h // block_size), -(-w // block_size)
    total = nbr * nbc
    n_zero = int(round(total * sparsity))
    rng = np.random.default_rng(seed)
    flat = np.ones(total, dtype=bool)
    zero_idx = rng.choice(total, size=n_zero, replace=False)
    flat[zero_idx] = False
    mask = np.repeat(np.repeat(flat.reshape(nbr, nbc), block_size, 0),
                     block_size, 1)
    return mask[:h, :w]


def make_sparse_weight(
    shape: Tuple[int, int],
    block_size: int,
    sparsity: float,
    seed: int = 42,
    scale: float = 0.05,
) -> np.ndarray:
    """FP32 weight matrix with exact block sparsity."""
    rng = np.random.default_rng(seed)
    w = rng.normal(0, scale, shape).astype(np.float32)
    return w * create_sparse_mask(shape, block_size, sparsity, seed)


def export_fixture(
    name: str,
    weight_fp32: np.ndarray,
    out_dir: str,
    block_size: int,
    extra_meta: Optional[Dict] = None,
) -> None:
    """Quantize per channel, pack to BSR and write the fixture directory:
    the layer files, ``scales.npy``, a seeded ``bias.npy`` and
    ``metadata.json``."""
    os.makedirs(out_dir, exist_ok=True)
    _, scales = quantize_symmetric_per_channel(weight_fp32, axis=0)
    bsr = build_bsr(weight_fp32, block_size, threshold=1e-10,
                    quantize=True, scales=scales)
    save_layer_dir(bsr, out_dir, name)
    np.save(os.path.join(out_dir, "scales.npy"), scales)
    rng = np.random.default_rng(7)
    bias = rng.normal(0, 0.01, weight_fp32.shape[0]).astype(np.float32)
    np.save(os.path.join(out_dir, "bias.npy"), bias)
    meta = {
        "input_dim": int(weight_fp32.shape[1]),
        "output_dim": int(weight_fp32.shape[0]),
        "block_size": block_size,
        "actual_sparsity": float(bsr.sparsity_pct),
    }
    if extra_meta:
        meta.update(extra_meta)
    with open(os.path.join(out_dir, "metadata.json"), "w") as f:
        json.dump(meta, f, indent=2)


def generate_all_fixtures(root: str, seed: int = 42) -> Dict[str, str]:
    """Write the whole fixture tree under ``root``; returns
    {fixture name: its directory}."""
    made = {}

    # Transformer Q/K/V @ 80% and 90%, 8x8 blocks.
    d_model, d_head = 128, 64
    for sp in (0.8, 0.9):
        for mat in ("q", "k", "v"):
            d = os.path.join(root, "transformer", f"{int(sp*100)}pct",
                             mat)
            w = make_sparse_weight((d_head, d_model), 8, sp,
                                   seed=seed + hash(mat) % 97)
            export_fixture(f"attn_{mat}", w, d, 8,
                           {"target_sparsity": sp * 100})
            made[f"transformer/{int(sp*100)}pct/{mat}"] = d

    # MLP FC layers @ 90%, 8x8.
    for (o, i) in ((128, 512), (256, 1024), (128, 9216)):
        d = os.path.join(root, "mlp", f"fc_{i}_{o}")
        w = make_sparse_weight((o, i), 8, 0.9, seed=seed + i)
        export_fixture(f"fc_{i}_{o}", w, d, 8,
                       {"target_sparsity": 90.0})
        made[f"mlp/fc_{i}_{o}"] = d

    # Conv layers (flattened) @ 50/60/75%, 4x4.
    for (o, i, sp) in ((32, 1, 0.5), (64, 32, 0.6), (128, 64, 0.75)):
        d = os.path.join(root, "conv", f"conv_{i}_{o}_k3")
        w4 = np.random.default_rng(seed + o).normal(
            0, 0.05, (o, i, 3, 3)).astype(np.float32)
        w2 = conv_weight_to_2d(w4)
        w2 = w2 * create_sparse_mask(w2.shape, 4, sp, seed + o)
        export_fixture(f"conv_{i}_{o}_k3", w2, d, 4,
                       {"target_sparsity": sp * 100, "kernel": 3})
        made[f"conv/conv_{i}_{o}_k3"] = d
    return made
