"""Sharded training and serving: dp and tp over a device mesh.

Counterpart of ``resnet_accel_tpu/parallel/sharded.py``.

- ``make_sharded_train_step``: the MNIST trainer's Adam step over a
  ``("dp", "tp")`` mesh: the batch split over dp (gradients summed over
  it, the loss a mean over the global batch), fc1's output features split
  over tp (each rank holds its rows; the activations all-gathered).  The
  JAX package leaves the collectives to XLA's sharding; here each rank
  runs them itself.
- ``make_data_parallel_forward``: batched int8 serving with the batch
  split over dp.  Each rank holds the whole quantized model (ResNet-18, any
  depth of the family, or the MNIST CNN) and serves its slice through the
  port's engine, so the kernels run in every rank (on a card: K1, K2, K3,
  and K4 for BSR layers; on the CPU their plain versions); the logits are
  all-gathered.  (The JAX package runs its XLA path under sharding; the
  port has no such switch.)
- ``make_dp_bsr_matmul``: the zero-skip BSR GEMM (K4) with its rows split
  over dp, weights replicated: the counterpart of the JAX package's
  ``tests/test_shard_map_kernel.py``, the kernel unchanged under the mesh.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from resnet_accel_tpu_torch.parallel.collectives import (all_gather,
                                                         axis_size, psum)
from resnet_accel_tpu_torch.parallel.mesh import (batch_sharding,
                                                  tp_row_sharding)
from resnet_accel_tpu_torch.parallel.pipeline import _mnist_parts
from resnet_accel_tpu_torch.runtime.backend import resolve_device


def _param_shardings(params: Dict) -> Dict[str, bool]:
    """Which parameters are split over tp (rows of fc1's weight and its
    bias); everything else is replicated.  (The conv weights are small:
    splitting their channels would cost more in collectives than it
    saves.)"""
    return {name: name in ("fc1.weight", "fc1.bias") for name in params}


#: The axes over which each parameter's gradient is summed.  Every rank's
#: loss is its dp slice's mean / dp, and a replicated value's cotangent is
#: whole on each rank (``collectives``), so: a tp-split parameter (fc1)
#: sums over dp only; the conv trunk, whose cotangent reaches each tp rank
#: through that rank's fc1 rows only, sums over dp and tp; fc2, computed
#: the same in every tp rank from the gathered activations, sums over dp
#: only.
GRAD_AXES = {"conv1.weight": ("dp", "tp"), "conv1.bias": ("dp", "tp"),
             "conv2.weight": ("dp", "tp"), "conv2.bias": ("dp", "tp"),
             "fc1.weight": ("dp",), "fc1.bias": ("dp",),
             "fc2.weight": ("dp",), "fc2.bias": ("dp",)}


def sharded_mnist_forward(params: Dict[str, torch.Tensor], x: torch.Tensor,
                          mesh: DeviceMesh) -> torch.Tensor:
    """The MNIST CNN forward of one rank: ``x`` its dp slice, ``params``
    with fc1 holding this rank's rows; the fc1 activations all-gathered
    over tp."""
    c1, c2, _, _ = _mnist_parts(params)
    a = c2(c1(x))
    a = a @ params["fc1.weight"].T + params["fc1.bias"]
    a = torch.maximum(a, a.new_zeros(()))
    a = all_gather(a, mesh, "tp", dim=1)
    return a @ params["fc2.weight"].T + params["fc2.bias"]


def make_sharded_train_step(mesh: DeviceMesh, lr: float = 1e-3,
                            device="cuda"):
    """(init_fn, step_fn, shard_batch) for the dp x tp Adam step of the
    MNIST CNN.  ``init_fn(params)`` puts this rank's share of the numpy
    params on ``device``; ``step_fn(params, opt, x, y)`` -> (params, opt,
    loss) with ``x``, ``y`` this rank's dp slice and ``loss`` the global
    batch's mean, the same on every rank."""
    from resnet_accel_tpu_torch.ops.flash_attention import fp32_matmuls
    fp32_matmuls()
    dev = resolve_device(device)
    dp = axis_size(mesh, "dp")

    def init_fn(params: Dict[str, np.ndarray]):
        split = _param_shardings(params)
        p = {}
        for k, v in params.items():
            t = torch.from_numpy(np.asarray(v, np.float32))
            if split[k]:
                t = tp_row_sharding(t, mesh)
            p[k] = t.to(dev).clone().requires_grad_(True)
        return p, torch.optim.Adam(list(p.values()), lr=lr)

    def step_fn(params, opt, x, y):
        opt.zero_grad(set_to_none=False)
        logits = sharded_mnist_forward(params, x, mesh)
        local = F.cross_entropy(logits, y.long(), reduction="mean") / dp
        local.backward()
        with torch.no_grad():
            for k, v in params.items():
                g = v.grad
                for ax in GRAD_AXES[k]:
                    g = psum(g, mesh, ax)
                v.grad.copy_(g)
        opt.step()
        return params, opt, float(psum(local.detach(), mesh, "dp"))

    def shard_batch(x: np.ndarray, y: np.ndarray):
        return (batch_sharding(torch.as_tensor(x, device=dev), mesh),
                batch_sharding(torch.as_tensor(y, device=dev), mesh))

    return init_fn, step_fn, shard_batch


def make_data_parallel_forward(model, mesh: DeviceMesh, device="cuda"):
    """Data-parallel int8 serving: returns ``(fwd, params, put_batch)``.
    ``params`` is this rank's module (the whole model, replicated),
    ``put_batch(x)`` this rank's dp slice of the global numpy batch on the
    device, and ``fwd(params, xb)`` the logits of the GLOBAL batch,
    all-gathered over dp, the same on every rank."""
    from resnet_accel_tpu_torch.runtime.engine import InferenceEngine
    eng = InferenceEngine(model, device=device)

    @torch.inference_mode()
    def fwd(module, xb: torch.Tensor) -> torch.Tensor:
        return all_gather(module(xb), mesh, "dp", dim=0)

    def put_batch(x: np.ndarray) -> torch.Tensor:
        xt = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        return batch_sharding(xt, mesh).contiguous().to(eng.device)

    return fwd, eng.module, put_batch


def make_dp_bsr_matmul(mesh: DeviceMesh, bsr, device="cuda") -> Callable:
    """``fwd(a)``: int8 A [M, K] (numpy or tensor, the whole batch) @ W^T
    for the int8 BSR weight ``bsr`` (``sparse.BSRMatrix``), M split over dp:
    each rank runs K4 (``ops.bsr_matmul_wt``; its plain version on the CPU)
    on its rows with the weight replicated, and the int32 rows are
    all-gathered."""
    from resnet_accel_tpu_torch.ops import bsr_matmul_wt, pack_bsr
    dev = resolve_device(device)
    pk = pack_bsr(bsr, dev)

    @torch.inference_mode()
    def fwd(a) -> torch.Tensor:
        a = batch_sharding(torch.as_tensor(np.asarray(a), dtype=torch.int8),
                           mesh).contiguous().to(dev)
        return all_gather(bsr_matmul_wt(a, pk), mesh, "dp", dim=0)
    return fwd
