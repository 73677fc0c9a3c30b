"""ResNet-18 (and the family) training through torch.autograd.

Counterpart of ``resnet_accel_tpu/train/resnet18.py``: CIFAR or ImageNet
geometry with live BatchNorm (batch statistics in training, running
statistics tracked for inference), SGD with momentum and weight decay, and
block masks re-applied after every optimizer step.  The trained
(params, bn_state) pair feeds ``models.resnet18.quantize_resnet18``
through ``export_inference_params``.

As in the JAX package, BatchNorm normalizes by the biased batch variance
and updates ``running_var`` with it too (``nn.BatchNorm2d`` would update
it with the unbiased one); ReLU is ``torch.maximum`` and the 3x3/s2 max
pool a chain of pairwise maxima over strided slices, so that gradients
split at ties as JAX's do.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from resnet_accel_tpu_torch.models.resnet18 import STAGES, init_resnet18_fp32
from resnet_accel_tpu_torch.ops.flash_attention import fp32_matmuls
from resnet_accel_tpu_torch.runtime.backend import resolve_device
from resnet_accel_tpu_torch.train.mnist import (host_floats, reapply, relu,
                                                to_device, to_host)

BN_MOMENTUM = 0.1
BN_EPS = 1e-5


def split_params(flat: Dict[str, np.ndarray]):
    """Split a torchvision-style flat dict into (trainable, bn_state)."""
    train, state = {}, {}
    for k, v in flat.items():
        if k.endswith(".running_mean") or k.endswith(".running_var"):
            state[k] = np.asarray(v, np.float32)
        else:
            train[k] = np.asarray(v, np.float32)
    return train, state


def merge_params(train: Dict, state: Dict) -> Dict[str, np.ndarray]:
    out = {k: np.asarray(v) for k, v in train.items()}
    out.update({k: np.asarray(v) for k, v in state.items()})
    return out


def _bn(name, x, p, s, training):
    gamma = p[f"{name}.weight"][None, :, None, None]
    beta = p[f"{name}.bias"][None, :, None, None]
    if training:
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        with torch.no_grad():
            new_s = {
                f"{name}.running_mean":
                    (1 - BN_MOMENTUM) * s[f"{name}.running_mean"]
                    + BN_MOMENTUM * mean,
                f"{name}.running_var":
                    (1 - BN_MOMENTUM) * s[f"{name}.running_var"]
                    + BN_MOMENTUM * var,
            }
    else:
        mean = s[f"{name}.running_mean"]
        var = s[f"{name}.running_var"]
        new_s = {}
    y = (x - mean[None, :, None, None]) * torch.rsqrt(
        var[None, :, None, None] + BN_EPS)
    return y * gamma + beta, new_s


def _conv(name, x, p, stride, padding):
    return F.conv2d(x, p[f"{name}.weight"], stride=stride, padding=padding)


def max_pool_3x3_s2(a: torch.Tensor) -> torch.Tensor:
    """3x3/s2 max pool, padding 1, as pairwise maxima of nine strided
    slices of the -inf padded input: the output is ``F.max_pool2d(a, 3, 2,
    1)``'s, and the gradient at ties splits as JAX's ``jnp.maximum``
    chain's (train/resnet18.py:95-104).  That chain's slices take
    ``H // 2 + 1`` rows, which is the pool's height only for odd H; these
    take ``(H - 1) // 2 + 1``, any H."""
    H, W = a.shape[2:]
    Ho, Wo = (H - 1) // 2 + 1, (W - 1) // 2 + 1
    ap = F.pad(a, (1, 1, 1, 1), value=float("-inf"))
    m = None
    for i in range(3):
        for j in range(3):
            sl = ap[:, :, i:i + 2 * (Ho - 1) + 1:2, j:j + 2 * (Wo - 1) + 1:2]
            m = sl if m is None else torch.maximum(m, sl)
    return m


def resnet18_forward(p, s, x, small_input: bool, training: bool,
                     stages=None, bottleneck: bool = False):
    """Returns (logits, updated bn_state).  ``stages``/``bottleneck``
    generalize to the family plans (models/resnet.py); defaults are
    ResNet-18.  ``p`` and ``s`` are dicts of tensors; the updates are
    computed without gradient."""
    stages = STAGES if stages is None else stages
    updates = {}

    def bn(name, x):
        y, u = _bn(name, x, p, s, training)
        updates.update(u)
        return y

    a = _conv("conv1", x, p, 1 if small_input else 2,
              1 if small_input else 3)
    a = relu(bn("bn1", a))
    if not small_input:
        a = max_pool_3x3_s2(a)

    for si, (out_c, blocks, stride) in enumerate(stages, start=1):
        for b in range(blocks):
            base = f"layer{si}.{b}"
            st = stride if b == 0 else 1
            if bottleneck:
                y = _conv(f"{base}.conv1", a, p, 1, 0)
                y = relu(bn(f"{base}.bn1", y))
                y = _conv(f"{base}.conv2", y, p, st, 1)
                y = relu(bn(f"{base}.bn2", y))
                y = _conv(f"{base}.conv3", y, p, 1, 0)
                y = bn(f"{base}.bn3", y)
            else:
                y = _conv(f"{base}.conv1", a, p, st, 1)
                y = relu(bn(f"{base}.bn1", y))
                y = _conv(f"{base}.conv2", y, p, 1, 1)
                y = bn(f"{base}.bn2", y)
            if f"{base}.downsample.0.weight" in p:
                r = _conv(f"{base}.downsample.0", a, p, st, 0)
                r = bn(f"{base}.downsample.1", r)
            else:
                r = a
            a = relu(y + r)

    a = torch.mean(a, dim=(2, 3))
    logits = a @ p["fc.weight"].T + p["fc.bias"]
    return logits, updates


@dataclasses.dataclass
class TrainState:
    """The trained parameters and running statistics (numpy, on the
    host), the optimizer's ``state_dict()`` and the per-epoch history."""

    params: Dict
    bn_state: Dict
    opt_state: object
    history: list


def train_resnet18(
    images: np.ndarray,
    labels: np.ndarray,
    epochs: int = 1,
    batch_size: int = 32,
    lr: float = 0.05,
    momentum: float = 0.9,
    weight_decay: float = 5e-4,
    seed: int = 0,
    num_classes: int = 10,
    small_input: bool = True,
    mask_fn: Optional[Callable] = None,
    reg_fn: Optional[Callable] = None,
    init: Optional[Dict[str, np.ndarray]] = None,
    stages=None,
    bottleneck: bool = False,
    device="cuda",
) -> TrainState:
    """SGD-momentum training with per-step mask re-application.

    ``images``: fp32 NCHW (normalized); ``mask_fn``/``reg_fn`` as in
    ``train.mnist`` (the BlockSparsePruner hooks).  Runs on ``device``
    (``"cuda"`` by default; it raises without a card).
    """
    dev = resolve_device(device)
    fp32_matmuls()
    flat = init if init is not None else init_resnet18_fp32(
        seed=seed, num_classes=num_classes, small_input=small_input,
        stages=stages, bottleneck=bottleneck)
    params, bn_state = split_params(flat)
    p = to_device(params, dev)
    s = {k: torch.from_numpy(v).to(dev) for k, v in bn_state.items()}
    opt = torch.optim.SGD(list(p.values()), lr=lr, momentum=momentum,
                          weight_decay=weight_decay)
    x_all = torch.from_numpy(np.asarray(images, np.float32)).to(dev)
    y_all = torch.from_numpy(np.asarray(labels).astype(np.int64)).to(dev)

    rng = np.random.default_rng(seed)
    n = len(images)
    history = []
    for epoch in range(epochs):
        perm = torch.from_numpy(rng.permutation(n)).to(dev)
        losses, accs = [], []
        for i in range(0, n - batch_size + 1, batch_size):
            idx = perm[i:i + batch_size]
            xb, yb = x_all[idx], y_all[idx]
            logits, updates = resnet18_forward(
                p, s, xb, small_input, True, stages=stages,
                bottleneck=bottleneck)
            loss = F.cross_entropy(logits, yb)
            if reg_fn is not None:
                loss = loss + reg_fn(p)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            s.update(updates)
            reapply(mask_fn, p)
            losses.append(loss.detach())
            accs.append((logits.detach().argmax(-1) == yb).float().mean())
        history.append({"epoch": epoch,
                        "loss": float(np.mean(host_floats(losses))),
                        "train_acc": float(np.mean(host_floats(accs)))})
    return TrainState(params=to_host(p), bn_state=to_host(s),
                      opt_state=opt.state_dict(), history=history)


def export_inference_params(state: TrainState) -> Dict[str, np.ndarray]:
    """Merge trained params + running BN stats into the flat dict consumed
    by ``models.resnet18.quantize_resnet18``."""
    return merge_params(state.params, state.bn_state)
