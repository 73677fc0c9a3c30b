"""MNIST CNN training through torch.autograd.

Counterpart of ``resnet_accel_tpu/train/mnist.py``: the same architecture
(conv1 1->32 3x3, conv2 32->64 3x3, maxpool 2, fc1 9216->128, fc2
128->10), the same seeded He init and normalization, Adam, the same data
order, and the npz checkpoint with its ``.meta.json`` sidecar that the
CLI's ``quantize`` reads.  Parameters go in and come out as flat dicts of
numpy arrays under the JAX package's names, so a checkpoint of either
package feeds the other's quantizers.

The forward is written so that its gradients are JAX's at ties:
``torch.maximum`` (half to each side where both are equal) for ReLU, and
the 2x2 pool as a reshape-max (``amax``: split evenly among equal values).
Products and convolutions run in float32 with TF32 off.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from resnet_accel_tpu_torch.checkpoint import load_checkpoint
from resnet_accel_tpu_torch.models.mnist_cnn import MNIST_MEAN, MNIST_STD
from resnet_accel_tpu_torch.ops.flash_attention import fp32_matmuls
from resnet_accel_tpu_torch.runtime.backend import resolve_device

__all__ = ["init_mnist_params", "mnist_forward_fp32", "TrainResult",
           "train_mnist", "save_checkpoint", "load_checkpoint",
           "export_golden_vectors"]


def init_mnist_params(seed: int = 1917) -> Dict[str, np.ndarray]:
    """He-init FP32 params, deterministic (train_mnist.py:12-23 seeds)."""
    rng = np.random.default_rng(seed)

    def conv(o, i, k):
        return rng.normal(0, np.sqrt(2.0 / (i * k * k)),
                          (o, i, k, k)).astype(np.float32)

    def lin(o, i):
        return rng.normal(0, np.sqrt(2.0 / i), (o, i)).astype(np.float32)

    return {
        "conv1.weight": conv(32, 1, 3),
        "conv1.bias": np.zeros(32, np.float32),
        "conv2.weight": conv(64, 32, 3),
        "conv2.bias": np.zeros(64, np.float32),
        "fc1.weight": lin(128, 9216),
        "fc1.bias": np.zeros(128, np.float32),
        "fc2.weight": lin(10, 128),
        "fc2.bias": np.zeros(10, np.float32),
    }


def relu(x: torch.Tensor) -> torch.Tensor:
    """``max(x, 0)`` with JAX's gradient at 0: half of it."""
    return torch.maximum(x, x.new_zeros(()))


def normalize_mnist(images_u8: np.ndarray) -> np.ndarray:
    """uint8 [N, 28, 28] -> normalized float32 [N, 1, 28, 28]."""
    x = ((images_u8.astype(np.float32) / 255.0) - MNIST_MEAN) / MNIST_STD
    return x.reshape(-1, 1, 28, 28)


def to_device(params: Dict[str, np.ndarray], dev: torch.device,
              keys=None) -> Dict[str, torch.Tensor]:
    """Leaf float32 tensors on ``dev`` that autograd tracks, one a key of
    ``keys`` (default: every key)."""
    return {k: torch.tensor(np.asarray(params[k], np.float32), device=dev,
                            requires_grad=True)
            for k in (params if keys is None else keys)}


def to_host(params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def host_floats(values) -> list:
    """Python floats of a list of 0-dim tensors, one copy to the host."""
    return torch.stack(values).cpu().tolist() if values else []


def reapply(mask_fn: Optional[Callable], params: Dict[str, torch.Tensor]
            ) -> None:
    """``params`` (the optimizer's leaves) set in place to
    ``mask_fn(params)``."""
    if mask_fn is None:
        return
    with torch.no_grad():
        for k, v in mask_fn(params).items():
            if v is not params[k]:
                params[k].copy_(v)


def mnist_forward_fp32(params, x):
    """FP32 forward, NCHW (architecture of train_mnist.py:32-50)."""
    def conv(x, w, b):
        return F.conv2d(x, w) + b[None, :, None, None]

    a = relu(conv(x, params["conv1.weight"], params["conv1.bias"]))
    a = relu(conv(a, params["conv2.weight"], params["conv2.bias"]))
    N, C, H, W = a.shape
    a = a.reshape(N, C, H // 2, 2, W // 2, 2).amax(dim=(3, 5))
    a = a.reshape(a.shape[0], -1)
    a = relu(a @ params["fc1.weight"].T + params["fc1.bias"])
    return a @ params["fc2.weight"].T + params["fc2.bias"]


@dataclasses.dataclass
class TrainResult:
    params: Dict[str, np.ndarray]
    history: list
    best_acc: float
    seed: int
    hparams: Dict


def train_mnist(
    images_u8: np.ndarray,
    labels: np.ndarray,
    epochs: int = 2,
    batch_size: int = 128,
    lr: float = 1e-3,
    seed: int = 1917,
    eval_frac: float = 0.1,
    mask_fn: Optional[Callable] = None,
    reg_fn: Optional[Callable] = None,
    params: Optional[Dict[str, np.ndarray]] = None,
    device="cuda",
) -> TrainResult:
    """Adam training loop with optional sparsity mask re-application.

    ``mask_fn(params) -> params`` is applied after every optimizer step —
    the mask-re-apply discipline of the reference's BlockSparsePruner
    (train_resnet18.py:282-319).  ``reg_fn(params) -> scalar`` adds a
    regularizer (group lasso for block pruning).  Runs on ``device``
    (``"cuda"`` by default; it raises without a card).
    """
    dev = resolve_device(device)
    fp32_matmuls()
    x = normalize_mnist(images_u8)
    y = np.asarray(labels, np.int64)

    n_eval = max(1, int(len(x) * eval_frac))
    x_eval = torch.from_numpy(x[:n_eval]).to(dev)
    y_eval = torch.from_numpy(y[:n_eval]).to(dev)
    x_tr = torch.from_numpy(x[n_eval:]).to(dev)
    y_tr = torch.from_numpy(y[n_eval:]).to(dev)

    if params is None:
        params = init_mnist_params(seed)
    p = to_device(params, dev)
    opt = torch.optim.Adam(list(p.values()), lr=lr)

    rng = np.random.default_rng(seed)
    history, best_acc = [], 0.0
    n = len(x_tr)
    for epoch in range(epochs):
        perm = torch.from_numpy(rng.permutation(n)).to(dev)
        losses = []
        for i in range(0, n - batch_size + 1, batch_size):
            idx = perm[i:i + batch_size]
            loss = F.cross_entropy(mnist_forward_fp32(p, x_tr[idx]),
                                   y_tr[idx])
            if reg_fn is not None:
                loss = loss + reg_fn(p)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            reapply(mask_fn, p)
            losses.append(loss.detach())
        with torch.no_grad():
            pred = mnist_forward_fp32(p, x_eval).argmax(-1)
            acc = float((pred == y_eval).float().mean())
        best_acc = max(best_acc, acc)
        history.append({"epoch": epoch,
                        "loss": float(np.mean(host_floats(losses))),
                        "eval_acc": acc})
    return TrainResult(
        params=to_host(p), history=history, best_acc=best_acc, seed=seed,
        hparams={"epochs": epochs, "batch_size": batch_size, "lr": lr})


def save_checkpoint(result: TrainResult, path: str) -> None:
    """Checkpoint with seed/hparams/best_acc audit trail
    (train_mnist.py:147-159 parity), as npz + json sidecar."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **result.params)
    with open(path + ".meta.json", "w") as f:
        json.dump({"seed": result.seed, "hparams": result.hparams,
                   "best_acc": result.best_acc,
                   "history": result.history}, f, indent=2)


def export_golden_vectors(
    result: TrainResult, images_u8: np.ndarray, out_dir: str,
    num: int = 32, device="cuda",
) -> None:
    """Save golden inputs + fp32 logits (train_mnist.py:161-166 parity)."""
    dev = resolve_device(device)
    fp32_matmuls()
    os.makedirs(out_dir, exist_ok=True)
    imgs = images_u8[:num]
    np.save(os.path.join(out_dir, "mnist_inputs.npy"), imgs)
    with torch.no_grad():
        logits = mnist_forward_fp32(
            {k: torch.from_numpy(np.asarray(v)).to(dev)
             for k, v in result.params.items()},
            torch.from_numpy(normalize_mnist(imgs)).to(dev))
    np.save(os.path.join(out_dir, "mnist_logits_fp32.npy"),
            logits.cpu().numpy())
