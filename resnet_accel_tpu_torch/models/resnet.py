"""The INT8 ResNet family (18/34/50/101/152): dispatch on depth.

Counterpart of ``resnet_accel_tpu/models/resnet.py``.  Depths 18 and 34
use basic blocks, 50, 101 and 152 bottlenecks (1x1 -> 3x3 -> 1x1,
expansion 4), over torchvision's stage plans (``STAGE_PLANS``).  Every
depth returns the same ``ResNet18Int8`` container, so
``ResNet18Int8Module``, ``attach_bsr``, the engine and the CLI serve all
of them.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np

from resnet_accel_tpu_torch.models.resnet18 import (
    BOTTLENECK_DEPTHS,
    EXPANSION,
    STAGE_PLANS,
    ResNet18Int8,
    init_resnet18_fp32,
    quantize_resnet18,
)


def _plan(depth: int):
    if depth not in STAGE_PLANS:
        raise ValueError(
            f"unsupported depth {depth}; choose {sorted(STAGE_PLANS)}")
    return STAGE_PLANS[depth], depth in BOTTLENECK_DEPTHS


class TrunkConv(NamedTuple):
    """One trunk conv: its name in the forward (``b{block}.{c1,c2,c3,ds}``),
    its stage (1-4), input channels, output channels, input height and
    width, kernel and stride (padding kernel // 2)."""

    name: str
    stage: int
    C: int
    O: int
    H: int
    kernel: int
    stride: int


def trunk_convs(depth: int, hw: int = 56) -> List[TrunkConv]:
    """Every trunk conv of the ResNet of ``depth`` whose stage 1 sees ``hw``
    x ``hw`` (56 at 224 x 224), in the forward's order: c1, ds, c2 (and c3
    in a bottleneck, which carries the stride on its 3x3 c2)."""
    stages, bottleneck = _plan(depth)
    convs: List[TrunkConv] = []
    c_in, blk = 64, 0
    for si, (out_c, blocks, stride) in enumerate(stages, start=1):
        for b in range(blocks):
            st = stride if b == 0 else 1
            exp_c = out_c * EXPANSION if bottleneck else out_c
            n = f"b{blk}"
            if bottleneck:
                convs.append(TrunkConv(f"{n}.c1", si, c_in, out_c, hw, 1, 1))
            else:
                convs.append(TrunkConv(f"{n}.c1", si, c_in, out_c, hw, 3, st))
            if st != 1 or c_in != exp_c:
                convs.append(TrunkConv(f"{n}.ds", si, c_in, exp_c, hw, 1, st))
            if bottleneck:
                convs.append(TrunkConv(f"{n}.c2", si, out_c, out_c, hw, 3, st))
                convs.append(TrunkConv(f"{n}.c3", si, out_c, exp_c, hw // st,
                                       1, 1))
            else:
                convs.append(TrunkConv(f"{n}.c2", si, out_c, out_c, hw // st,
                                       3, 1))
            c_in, hw, blk = exp_c, hw // st, blk + 1
    return convs


def init_resnet_fp32(
    depth: int = 18, seed: int = 0, num_classes: int = 1000,
    small_input: bool = False,
) -> Dict[str, np.ndarray]:
    """He-init fp32 parameters for any depth of the family (torchvision
    names), the same numbers as the JAX package's."""
    stages, bottleneck = _plan(depth)
    return init_resnet18_fp32(
        seed=seed, num_classes=num_classes, small_input=small_input,
        stages=stages, bottleneck=bottleneck)


def quantize_resnet(
    params_fp32: Dict[str, np.ndarray],
    calib_x: np.ndarray,
    depth: int = 18,
    num_classes: int = 1000,
    small_input: bool = False,
) -> ResNet18Int8:
    """Fold BN, quantize per channel to int8 and calibrate the activation
    scales for any depth of the family."""
    stages, bottleneck = _plan(depth)
    return quantize_resnet18(
        params_fp32, calib_x, num_classes=num_classes,
        small_input=small_input, stages=stages, bottleneck=bottleneck)
