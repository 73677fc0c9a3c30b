"""The INT8 ResNet family (18/34/50/101/152): dispatch on depth.

Counterpart of ``resnet_accel_tpu/models/resnet.py``.  Depths 18 and 34
use basic blocks, 50, 101 and 152 bottlenecks (1x1 -> 3x3 -> 1x1,
expansion 4), over torchvision's stage plans (``STAGE_PLANS``).  Every
depth returns the same ``ResNet18Int8`` container, so
``ResNet18Int8Module``, ``attach_bsr``, the engine and the CLI serve all
of them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from resnet_accel_tpu_torch.models.resnet18 import (
    BOTTLENECK_DEPTHS,
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
