"""An INT8 ResNet of the program, built from a cardbench configuration.

The benchmark makes the raw inputs from the seed and hands the same to the
program and to the reference: fp32 parameters in torchvision's names (He
normal conv weights, BatchNorm with unit scale, zero shift, running means
N(0, 0.1) and variances U(0.5, 1.5), fc weights N(0, 0.01), zero fc bias),
fp32 calibration images and fp32 library images, all N(0, 1), drawn on
the device by ``torch.Generator`` in a few large calls.  The program
prunes (where the configuration says so), folds, quantizes and calibrates
them with its own functions, and serves the library through its
``InferenceEngine``.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from cardbench.reference.resnet_int8 import (Inputs, expansion,
                                             is_bottleneck, stage_plan,
                                             stem_conv, trunk)


def substream(seed: int, tag: str) -> int:
    """A 63-bit generator seed for the stream ``tag`` of run seed ``seed``."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def _generator(device, seed: int, tag: str) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(substream(seed, tag))
    return g


def param_specs(config) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, what) of every fp32 parameter, in torchvision's names;
    ``what`` is conv, bn_w, bn_b, bn_mean, bn_var, fc_w or fc_b."""
    specs = []

    def conv(c):
        specs.append((f"{c.name}.weight",
                      (c.out_c, c.in_c, c.kernel, c.kernel), "conv"))
        for suffix, what in (("weight", "bn_w"), ("bias", "bn_b"),
                             ("running_mean", "bn_mean"),
                             ("running_var", "bn_var")):
            specs.append((f"{c.bn}.{suffix}", (c.out_c,), what))

    conv(stem_conv(config))
    for convs in trunk(config):
        for c in convs:
            conv(c)
    feat = config["widths"][-1] * expansion(config)
    specs.append(("fc.weight", (config["num_classes"], feat), "fc_w"))
    specs.append(("fc.bias", (config["num_classes"],), "fc_b"))
    return specs


def make_weights(config, seed: int, device) -> Dict[str, np.ndarray]:
    """The fp32 parameters of run seed ``seed``: one normal and one uniform
    draw on ``device``, scaled per tensor, copied to the host once."""
    specs = param_specs(config)
    normal = [(n, s, w) for n, s, w in specs
              if w in ("conv", "bn_mean", "fc_w")]
    uniform = [(n, s, w) for n, s, w in specs if w == "bn_var"]
    g = _generator(device, seed, "weights")
    sizes = [math.prod(s) for _, s, _ in normal]
    std = torch.tensor([math.sqrt(2.0 / math.prod(s[1:])) if w == "conv"
                        else 0.1 if w == "bn_mean" else 0.01
                        for _, s, w in normal], device=device)
    z = torch.randn(sum(sizes), generator=g, device=device)
    z *= torch.repeat_interleave(std, torch.tensor(sizes, device=device))
    u = torch.rand(sum(math.prod(s) for _, s, _ in uniform), generator=g,
                   device=device) + 0.5
    z, u = z.cpu().numpy(), u.cpu().numpy()
    out: Dict[str, np.ndarray] = {}
    for group, flat in ((normal, z), (uniform, u)):
        i = 0
        for name, shape, _ in group:
            n = math.prod(shape)
            out[name] = flat[i:i + n].reshape(shape)
            i += n
    for name, shape, what in specs:
        if what == "bn_w":
            out[name] = np.ones(shape, np.float32)
        elif what in ("bn_b", "fc_b"):
            out[name] = np.zeros(shape, np.float32)
    return out


def images(config, seed: int, tag: str, count: int, device) -> torch.Tensor:
    """``count`` fp32 NCHW images N(0, 1) of stream ``tag``, on
    ``device``."""
    hw = config["image_size"]
    return torch.randn((count, config["in_channels"], hw, hw),
                       generator=_generator(device, seed, tag),
                       device=device)


def inputs(config, seed: int, device) -> Inputs:
    """The raw inputs of run seed ``seed`` that program and reference both
    take: the fp32 parameters and the calibration images."""
    return Inputs(make_weights(config, seed, device),
                  images(config, seed, "calib", config["calibration_images"],
                         device).cpu().numpy())


def _depth(config) -> int:
    """The program's depth whose stage plan is the configuration's."""
    from resnet_accel_tpu_torch.models.resnet18 import (BOTTLENECK_DEPTHS,
                                                        STAGE_PLANS)
    want = [tuple(p) for p in stage_plan(config)]
    for depth, plan in STAGE_PLANS.items():
        if [tuple(p) for p in plan] == want and (
                depth in BOTTLENECK_DEPTHS) == is_bottleneck(config):
            return depth
    raise ValueError(f"the program has no ResNet with stages {want}")


def build(config, inputs: Inputs):
    """The program's quantized model: pruned by block magnitude and given
    its BSR weights where the configuration is sparse."""
    from resnet_accel_tpu_torch.models.resnet18 import (
        BOTTLENECK_DEPTHS, STAGE_PLANS, attach_bsr, prune_params_blockwise,
        quantize_resnet18)
    depth = _depth(config)
    if (config["stem_kernel"], config["stem_stride"]) != (7, 2):
        raise ValueError("the program's ImageNet stem is 7 x 7, stride 2")
    weights = inputs.params
    sp = config.get("sparsity")
    if sp:
        bh, bw = sp["block"]
        if bh != bw:
            raise ValueError("the program prunes square blocks only")
        weights = prune_params_blockwise(weights, sp["target"], block=bh)
    model = quantize_resnet18(weights, inputs.calib, config["num_classes"],
                              stages=STAGE_PLANS[depth],
                              bottleneck=depth in BOTTLENECK_DEPTHS)
    if sp:
        model = attach_bsr(model, block=sp["block"][0])
    return model


def engine(model, device):
    from resnet_accel_tpu_torch.runtime.engine import InferenceEngine
    return InferenceEngine(model, device=device)


def quantize(model, x: torch.Tensor) -> torch.Tensor:
    """The program's input quantization with its calibrated scale."""
    from resnet_accel_tpu_torch.ops.epilogue import quantize_input
    return quantize_input(x, model.s_input)


def state(model) -> Dict[str, int]:
    """The program's state that the reference checks: the stored blocks
    of each conv it serves block-sparse."""
    return {scope: int(qc.bsr.nnz_blocks) for scope, qc in model.named_convs()
            if qc.bsr is not None}
