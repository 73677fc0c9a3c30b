"""Quantization-aware training: fake-quant fine-tuning with a
straight-through gradient, through torch.autograd.

Counterpart of ``resnet_accel_tpu/train/qat.py``:

- weights: per-output-channel symmetric fake-quant (the PTQ scale
  formula), the gradient passed straight through (``x + (q - x).detach()``;
  the scale, inside the detached part, gets none);
- activations: per-tensor symmetric fake-quant at the taps where inference
  requantizes, with scales tracked by an EMA of the batch absmax (MNIST)
  or fixed by calibration (the ResNet family, BatchNorm frozen and folded
  as ``models.resnet18.fold_all_bn`` folds it).

``export_qat`` hands the tuned weights and learned activation scales to
``models.mnist_cnn.MNISTCNNInt8.from_arrays``; ``qat_finetune_resnet``
returns a flat dict for ``quantize_resnet18``.  Every scale enters as a
float32 tensor on the data's device (``ops.epilogue.scalar_f32``), so the
card divides as the CPU does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from resnet_accel_tpu_torch.models.mnist_cnn import MNISTCNNInt8
from resnet_accel_tpu_torch.models.resnet18 import (STAGES,
                                                    _float_forward_taps,
                                                    fold_all_bn)
from resnet_accel_tpu_torch.ops.epilogue import scalar_f32
from resnet_accel_tpu_torch.ops.flash_attention import fp32_matmuls
from resnet_accel_tpu_torch.quant import quantize_symmetric_per_channel
from resnet_accel_tpu_torch.runtime.backend import resolve_device
from resnet_accel_tpu_torch.train.mnist import (host_floats,
                                                init_mnist_params,
                                                normalize_mnist, reapply,
                                                relu, to_device)
from resnet_accel_tpu_torch.train.resnet18 import BN_EPS, split_params

EMA = 0.99
TAPS = ("x", "conv1", "conv2", "fc1")


def fake_quant(x, scale):
    """Quantize-dequantize with a straight-through gradient; ``scale`` a
    float32 tensor (or a float, taken as float32 on ``x``'s device)."""
    if not isinstance(scale, torch.Tensor):
        scale = scalar_f32(scale, x.device)
    q = torch.clamp(torch.round(x / scale), -128, 127) * scale
    return x + (q - x).detach()


def fake_quant_per_channel(w, axis: int = 0):
    """Per-output-channel symmetric fake-quant (PTQ scale formula)."""
    reduce_axes = tuple(i for i in range(w.ndim) if i != axis)
    maxabs = torch.amax(torch.abs(w), dim=reduce_axes, keepdim=True)
    scale = torch.clamp_min(maxabs / scalar_f32(127.0, w.device), 1e-12)
    return fake_quant(w, scale)


def _qat_forward(params, act_scales, x, train: bool):
    """MNIST forward with fake-quant at every inference tap.

    Returns (logits, observed absmax per tap) — the absmax feeds the EMA
    scale state exactly where inference requantizes.
    """
    obs = {}
    c127 = scalar_f32(127.0, x.device)

    def conv(v, w, b):
        return F.conv2d(v, fake_quant_per_channel(w)) + b[None, :, None, None]

    def act_fq(name, v):
        obs[name] = torch.amax(torch.abs(v.detach()))
        scale = torch.clamp_min(act_scales[name] / c127, 1e-12)
        return fake_quant(v, scale)

    a = act_fq("x", x)
    a = relu(conv(a, params["conv1.weight"], params["conv1.bias"]))
    a = act_fq("conv1", a)
    a = relu(conv(a, params["conv2.weight"], params["conv2.bias"]))
    a = act_fq("conv2", a)
    N, C, H, W = a.shape
    a = a.reshape(N, C, H // 2, 2, W // 2, 2).amax(dim=(3, 5))
    a = a.reshape(N, -1)
    a = relu(a @ fake_quant_per_channel(params["fc1.weight"]).T
             + params["fc1.bias"])
    a = act_fq("fc1", a)
    logits = a @ fake_quant_per_channel(params["fc2.weight"]).T \
        + params["fc2.bias"]
    return logits, obs


@dataclasses.dataclass
class QATResult:
    params: Dict[str, np.ndarray]
    act_absmax: Dict[str, float]     # EMA absmax per tap
    history: list


def qat_finetune(
    images_u8: np.ndarray,
    labels: np.ndarray,
    params: Optional[Dict[str, np.ndarray]] = None,
    epochs: int = 1,
    batch_size: int = 128,
    lr: float = 2e-4,
    seed: int = 0,
    mask_fn: Optional[Callable] = None,
    device="cuda",
) -> QATResult:
    """Fine-tune through the quantizer (optionally with sparsity masks),
    Adam, on ``device`` (``"cuda"`` by default; it raises without a
    card)."""
    dev = resolve_device(device)
    fp32_matmuls()
    x = torch.from_numpy(normalize_mnist(images_u8)).to(dev)
    y = torch.from_numpy(np.asarray(labels).astype(np.int64)).to(dev)

    if params is None:
        params = init_mnist_params(seed)
    p = to_device(params, dev)
    opt = torch.optim.Adam(list(p.values()), lr=lr)

    rng = np.random.default_rng(seed)
    n = len(x)
    history = []
    # Warm the EMA from one forward pass.
    with torch.no_grad():
        ones = {t: scalar_f32(1.0, dev) for t in TAPS}
        _, act_absmax = _qat_forward(p, ones, x[:batch_size], False)
    ema, rest = scalar_f32(EMA, dev), scalar_f32(1 - EMA, dev)

    for epoch in range(epochs):
        perm = torch.from_numpy(rng.permutation(n)).to(dev)
        losses = []
        for i in range(0, n - batch_size + 1, batch_size):
            idx = perm[i:i + batch_size]
            logits, obs = _qat_forward(p, act_absmax, x[idx], True)
            loss = F.cross_entropy(logits, y[idx])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            act_absmax = {t: ema * act_absmax[t] + rest * obs[t]
                          for t in TAPS}
            reapply(mask_fn, p)
            losses.append(loss.detach())
        history.append({"epoch": epoch,
                        "loss": float(np.mean(host_floats(losses)))})

    return QATResult(
        params={k: v.detach().cpu().numpy() for k, v in p.items()},
        act_absmax={t: float(act_absmax[t]) for t in TAPS},
        history=history)


def export_qat(result: QATResult) -> MNISTCNNInt8:
    """The deployed INT8 model of a QAT result: weights quantized with the
    per-channel scales QAT trained against, activation scales the learned
    EMA values."""
    weights, scales, biases = {}, {}, {}
    for layer in ("conv1", "conv2", "fc1", "fc2"):
        q, sc = quantize_symmetric_per_channel(
            result.params[f"{layer}.weight"], axis=0)
        weights[layer], scales[layer] = q, sc
        biases[layer] = result.params[f"{layer}.bias"]
    act_scales = tuple(
        max(result.act_absmax[t] / 127.0, 1e-12) for t in TAPS)
    return MNISTCNNInt8.from_arrays(weights, scales, biases, act_scales)


# ==========================================================================
# ResNet-family QAT (quant-aware fine-tune of a trained / pruned trunk)
# ==========================================================================
#
# BatchNorm frozen and folded into each conv (the inference fold), folded
# weights fake-quantized per output channel, activations fake-quantized at
# every tap quantize_resnet18 requantizes, with FIXED scales from the same
# calibration.  Gradients reach the conv weights and the BN affine
# (gamma/beta) through the STE; masks are re-applied after every step.


def calibrate_resnet_act_scales(
    flat: Dict[str, np.ndarray],
    calib_x: np.ndarray,
    small_input: bool = True,
    stages=None,
    bottleneck: bool = False,
    batch_size: int = 128,
    percentile: Optional[float] = None,
) -> Tuple[float, Dict[str, float]]:
    """(s_input, per-tap scales) of the BN-folded fp32 model — the same
    taps, batching and outlier clipping ``quantize_resnet18`` calibrates
    with, on the CPU."""
    folded = fold_all_bn(flat, stages=stages, bottleneck=bottleneck)
    calib_x = np.asarray(calib_x, np.float32)
    maxima: Dict[str, float] = {}
    with torch.inference_mode():
        for i in range(0, len(calib_x), batch_size):
            _, taps = _float_forward_taps(
                folded, torch.from_numpy(calib_x[i:i + batch_size]),
                small_input, stages=stages, bottleneck=bottleneck)
            for k, v in taps.items():
                m = (float(np.percentile(v.abs().numpy(), percentile))
                     if percentile is not None else float(v.abs().max()))
                maxima[k] = max(maxima.get(k, 0.0), m)
    s_input = max(float(np.abs(calib_x).max()) / 127.0, 1e-12)
    return s_input, {k: max(m / 127.0, 1e-12) for k, m in maxima.items()}


def _qat_resnet_forward(p, bn_state, x, s_input: float,
                        s_tap: Dict[str, float], small_input: bool,
                        stages, bottleneck: bool):
    """Frozen-BN fake-quant forward mirroring the INT8 inference graph
    (``models.resnet18._float_forward_taps`` tap for tap).  Its max pool
    routes a tie's gradient to one element, as JAX's ``reduce_window``
    does."""
    stages = STAGES if stages is None else stages
    eps = scalar_f32(BN_EPS, x.device)

    def conv(cname, bnname, v, stride, padding):
        k = p[f"{bnname}.weight"] * torch.rsqrt(
            bn_state[f"{bnname}.running_var"] + eps)
        w = p[f"{cname}.weight"] * k[:, None, None, None]
        b = p[f"{bnname}.bias"] - bn_state[f"{bnname}.running_mean"] * k
        y = F.conv2d(v, fake_quant_per_channel(w), stride=stride,
                     padding=padding)
        return y + b[None, :, None, None]

    def fq(name, v):
        return fake_quant(v, s_tap[name])

    a = fake_quant(x, s_input)
    a = relu(conv("conv1", "bn1", a, 1 if small_input else 2,
                  1 if small_input else 3))
    a = fq("stem", a)
    if not small_input:
        a = F.max_pool2d(a, 3, 2, padding=1)
    bi = 0
    s_prev = s_tap["stem"]
    for si, (out_c, blocks, stride) in enumerate(stages, start=1):
        for b in range(blocks):
            base = f"layer{si}.{b}"
            st = stride if b == 0 else 1
            if bottleneck:
                y = relu(conv(f"{base}.conv1", f"{base}.bn1", a, 1, 0))
                y = fq(f"b{bi}.c1", y)
                y = relu(conv(f"{base}.conv2", f"{base}.bn2", y, st, 1))
                y = fq(f"b{bi}.c2", y)
                y = conv(f"{base}.conv3", f"{base}.bn3", y, 1, 0)
                y = fq(f"b{bi}.c3", y)
            else:
                y = relu(conv(f"{base}.conv1", f"{base}.bn1", a, st, 1))
                y = fq(f"b{bi}.c1", y)
                y = conv(f"{base}.conv2", f"{base}.bn2", y, 1, 1)
                y = fq(f"b{bi}.c2", y)
            if f"{base}.downsample.0.weight" in p:
                r = conv(f"{base}.downsample.0", f"{base}.downsample.1",
                         a, st, 0)
                r = fq(f"b{bi}.ds", r)
            else:
                r = a
            a = relu(y + r)
            a = fq(f"b{bi}.out", a)
            s_prev = s_tap[f"b{bi}.out"]
            bi += 1
    a = torch.mean(a, dim=(2, 3))
    # Inference global-avgpools in the int8 domain at the last block's
    # scale; fake-quant the pooled tensor there so fc sees the deployed
    # input grid.
    a = fake_quant(a, s_prev)
    return a @ fake_quant_per_channel(p["fc.weight"]).T + p["fc.bias"]


def qat_finetune_resnet(
    flat: Dict[str, np.ndarray],
    images: np.ndarray,
    labels: np.ndarray,
    epochs: int = 2,
    batch_size: int = 128,
    lr: float = 5e-4,
    seed: int = 0,
    small_input: bool = True,
    stages=None,
    bottleneck: bool = False,
    mask_fn: Optional[Callable] = None,
    calib_x: Optional[np.ndarray] = None,
    calib_batch_size: int = 128,
    calib_percentile: Optional[float] = None,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Quant-aware fine-tune of a trained (optionally pruned) ResNet, Adam,
    on ``device`` (``"cuda"`` by default; it raises without a card).

    ``flat``: merged torchvision-style dict (``train.resnet18.merge_params``
    output).  Returns the same flat layout with fine-tuned conv/BN-affine
    /fc weights and UNCHANGED BN running stats — feed it straight to
    ``quantize_resnet18`` with the same calibration settings.
    """
    dev = resolve_device(device)
    fp32_matmuls()
    if calib_x is None:
        calib_x = images[:512]
    s_input, s_tap = calibrate_resnet_act_scales(
        flat, calib_x, small_input=small_input, stages=stages,
        bottleneck=bottleneck, batch_size=calib_batch_size,
        percentile=calib_percentile)

    params, bn_state = split_params(flat)
    p = to_device(params, dev)
    s = {k: torch.from_numpy(v).to(dev) for k, v in bn_state.items()}
    opt = torch.optim.Adam(list(p.values()), lr=lr)
    x_all = torch.from_numpy(np.asarray(images, np.float32)).to(dev)
    y_all = torch.from_numpy(np.asarray(labels).astype(np.int64)).to(dev)

    rng = np.random.default_rng(seed)
    n = len(images)
    for _ in range(epochs):
        perm = torch.from_numpy(rng.permutation(n)).to(dev)
        for i in range(0, n - batch_size + 1, batch_size):
            idx = perm[i:i + batch_size]
            logits = _qat_resnet_forward(
                p, s, x_all[idx], s_input, s_tap, small_input, stages,
                bottleneck)
            loss = F.cross_entropy(logits, y_all[idx])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            reapply(mask_fn, p)

    out = {k: v.detach().cpu().numpy() for k, v in p.items()}
    out.update(bn_state)
    return out
