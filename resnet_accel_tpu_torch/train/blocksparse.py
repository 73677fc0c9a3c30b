"""Progressive block-sparse pruning, the reference's pruning trainer.

Counterpart of ``resnet_accel_tpu/train/blocksparse.py``:
- global block-L2-norm ranking across all prunable layers with per-layer
  keep floors (``prune_blocks_global``), optionally ranked by RMS
  (``normalize``) and budgeted in weights (``by_params``);
- the progressive schedule 50 -> 70 -> 85 -> 90 % with fine-tuning between
  levels (``progressive_prune``);
- the group lasso (L2,1 over blocks) as a differentiable regularizer on
  tensors (``make_group_lasso_fn``);
- masks re-applied after every optimizer step (``make_mask_fn``).

The ranking, masks and sparsities are numpy, the same code as the JAX
package's, so both packages prune the same blocks of the same weights;
the mask and the lasso act on torch tensors on any device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class BlockCfg:
    """Per-layer pruning config (layer_block_cfg parity)."""

    block_h: int
    block_w: int
    min_keep: float  # fraction of blocks that must survive


#: Defaults mirroring the reference's intent, MXU-sized: FC layers prune
#: at 128x128 keep>=5%; conv layers at 32x32 on the flattened weight
#: keep>=30%.
DEFAULT_FC_CFG = BlockCfg(128, 128, 0.05)
DEFAULT_CONV_CFG = BlockCfg(32, 32, 0.30)
#: Reference-native sizes for exact replay of its flow.
REF_FC_CFG = BlockCfg(8, 8, 0.05)
REF_CONV_CFG = BlockCfg(4, 4, 0.30)


def _as_2d(w: np.ndarray) -> np.ndarray:
    return w.reshape(w.shape[0], -1)


def compute_block_norms(
    w: np.ndarray, cfg: BlockCfg
) -> Tuple[np.ndarray, Tuple[int, int]]:
    """L2 norm of each (padded) block of the flattened weight.

    Returns (norms [nbr, nbc], (nbr, nbc)).
    """
    w2 = _as_2d(np.asarray(w, np.float32))
    H, W = w2.shape
    ph, pw = -H % cfg.block_h, -W % cfg.block_w
    if ph or pw:
        w2 = np.pad(w2, ((0, ph), (0, pw)))
    nbr, nbc = w2.shape[0] // cfg.block_h, w2.shape[1] // cfg.block_w
    t = w2.reshape(nbr, cfg.block_h, nbc, cfg.block_w)
    norms = np.sqrt((t.astype(np.float64) ** 2).sum(axis=(1, 3)))
    return norms, (nbr, nbc)


def prune_blocks_global(
    params: Mapping[str, np.ndarray],
    target_sparsity: float,
    cfgs: Mapping[str, BlockCfg],
    normalize: bool = False,
    by_params: bool = False,
) -> Dict[str, np.ndarray]:
    """Rank ALL blocks across layers by L2 norm, zero the weakest.

    A layer never drops below ``cfg.min_keep`` of its blocks.
    ``normalize=True`` ranks by RMS (norm / sqrt(block elements)), so that
    layers with different block sizes compare fairly.  ``by_params=True``
    reads ``target_sparsity`` as the fraction of WEIGHTS to zero rather
    than of blocks (what ``effective_sparsity`` measures).

    Returns {layer_name: boolean keep-mask [nbr, nbc]}.
    """
    entries = []  # (norm, layer, br, bc)
    geom = {}
    elems = {name: cfgs[name].block_h * cfgs[name].block_w
             for name in cfgs}
    for name, cfg in cfgs.items():
        norms, (nbr, nbc) = compute_block_norms(params[name], cfg)
        if normalize:
            norms = norms / np.sqrt(cfg.block_h * cfg.block_w)
        geom[name] = (nbr, nbc)
        for br in range(nbr):
            for bc in range(nbc):
                entries.append((norms[br, bc], name, br, bc))

    weight = (lambda name: elems[name]) if by_params else (lambda name: 1)
    total = sum(weight(name) for _, name, _, _ in entries)
    budget = total * target_sparsity
    entries.sort(key=lambda e: e[0])

    masks = {name: np.ones(geom[name], dtype=bool) for name in cfgs}
    kept = {name: geom[name][0] * geom[name][1] for name in cfgs}
    floors = {name: int(np.ceil(cfgs[name].min_keep
                                * geom[name][0] * geom[name][1]))
              for name in cfgs}

    pruned = 0
    for norm, name, br, bc in entries:
        if pruned + weight(name) > budget:
            if by_params:
                continue  # a smaller later block may still fit
            break
        if kept[name] - 1 < floors[name]:
            continue  # keep floor reached for this layer
        masks[name][br, bc] = False
        kept[name] -= 1
        pruned += weight(name)
    return masks


def expand_mask(mask: np.ndarray, cfg: BlockCfg,
                shape: Tuple[int, ...]) -> np.ndarray:
    """Block mask [nbr, nbc] -> elementwise FP32 mask in weight shape."""
    full = np.repeat(np.repeat(mask, cfg.block_h, 0), cfg.block_w, 1)
    H = int(np.prod(shape[1:]))
    return full[:shape[0], :H].reshape(shape).astype(np.float32)


def make_mask_fn(
    masks: Mapping[str, np.ndarray],
    cfgs: Mapping[str, BlockCfg],
    shapes: Mapping[str, Tuple[int, ...]],
) -> Callable:
    """Build the after-every-step mask re-application function:
    ``mask_fn(params) -> params``, a dict of tensors with each masked
    weight multiplied by its elementwise mask (on the weight's device)."""
    dense_masks = {
        name: torch.from_numpy(expand_mask(masks[name], cfgs[name],
                                           shapes[name]))
        for name in masks
    }

    def mask_fn(params):
        out = dict(params)
        for name, m in dense_masks.items():
            if m.device != params[name].device:
                m = dense_masks[name] = m.to(params[name].device)
            out[name] = params[name] * m
        return out

    return mask_fn


def apply_mask_fn(mask_fn: Callable, params: Dict[str, np.ndarray]
                  ) -> Dict[str, np.ndarray]:
    """``mask_fn`` on numpy params (through CPU tensors), numpy out."""
    out = mask_fn({k: torch.tensor(np.asarray(v))
                   for k, v in params.items()})
    return {k: v.numpy() for k, v in out.items()}


def make_group_lasso_fn(
    cfgs: Mapping[str, BlockCfg], weight: float = 1e-4
) -> Callable:
    """L2,1 group-lasso over blocks (train_with_group_lasso :324-395):
    sum over blocks of their L2 norms — drives whole blocks to zero.
    ``reg_fn(params) -> scalar tensor``, differentiable; the ``1e-12``
    inside the root keeps a zero block's gradient finite."""

    def reg_fn(params):
        total = 0.0
        for name, cfg in cfgs.items():
            w = params[name].reshape(params[name].shape[0], -1)
            H, W = w.shape
            ph, pw = -H % cfg.block_h, -W % cfg.block_w
            if ph or pw:
                w = F.pad(w, (0, pw, 0, ph))
            t = w.reshape(w.shape[0] // cfg.block_h, cfg.block_h,
                          w.shape[1] // cfg.block_w, cfg.block_w)
            norms = torch.sqrt((t.float() ** 2).sum(dim=(1, 3)) + 1e-12)
            total = total + norms.sum()
        return weight * total

    return reg_fn


def sparsity_of_masks(masks: Mapping[str, np.ndarray]) -> float:
    total = sum(m.size for m in masks.values())
    kept = sum(int(m.sum()) for m in masks.values())
    return 1.0 - kept / total if total else 0.0


def effective_sparsity(
    masks: Mapping[str, np.ndarray],
    cfgs: Mapping[str, BlockCfg],
    shapes: Mapping[str, Tuple[int, ...]],
) -> float:
    """PARAMETER-weighted sparsity: zeroed weights / total weights of each
    real (unpadded) weight shape, where ``sparsity_of_masks`` counts
    blocks of any size alike."""
    total = kept = 0
    for name, mask in masks.items():
        cfg, shape = cfgs[name], shapes[name]
        dense = expand_mask(mask, cfg, shape)
        total += dense.size
        kept += int(dense.sum())
    return 1.0 - kept / total if total else 0.0


def progressive_prune(
    params: Dict[str, np.ndarray],
    finetune: Callable[[Dict[str, np.ndarray], Callable, Callable],
                       Dict[str, np.ndarray]],
    cfgs: Mapping[str, BlockCfg],
    schedule: List[float] = (0.5, 0.7, 0.85, 0.9),
    lasso_weight: float = 1e-4,
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Progressive magnitude pruning with fine-tuning between levels.

    ``finetune(params, mask_fn, reg_fn) -> params`` runs a few epochs of
    training (e.g. a partial ``train_mnist``) with masks re-applied per
    step.

    Returns (pruned params, final masks).
    """
    shapes = {name: params[name].shape for name in cfgs}
    reg_fn = make_group_lasso_fn(cfgs, lasso_weight)
    masks = None
    for level in schedule:
        masks = prune_blocks_global(params, level, cfgs)
        mask_fn = make_mask_fn(masks, cfgs, shapes)
        # hard-apply, then fine-tune with masks pinned
        params = apply_mask_fn(mask_fn, params)
        params = finetune(params, mask_fn, reg_fn)
        params = apply_mask_fn(mask_fn, params)
    return params, masks
