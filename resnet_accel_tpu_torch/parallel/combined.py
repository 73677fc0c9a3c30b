"""Combined multi-axis parallelism: dp x pp x tp in one program.

Counterpart of ``resnet_accel_tpu/parallel/combined.py``.  The batch splits
over ``dp``, the layer stack over ``pp`` (the GPipe loop of ``pipeline``,
``ppermute`` hops), and the wide products inside a stage over ``tp``
(Megatron column and row parallel with one ``psum``), all three at once in
each rank, forward AND backward.

Model: the MNIST CNN, split as

  pp stage 0:  conv1 -> relu -> conv2 -> relu -> 2x2 max pool -> flatten
  pp stage 1:  fc1 (column-parallel over tp) -> relu
               -> fc2 (row-parallel over tp) -> psum(tp)

Parameter storage is replicated (each rank slices its tp shard by its
index).  fc2's bias joins the partial logits of one rank (the last stage,
tp index 0) before the sums, so that each parameter is used by exactly
the ranks whose contribution it is.  The train step differentiates through
the hops (``ppermute``: the reverse hop) and the sums (``psum``: the
cotangent passes through), each rank with its dp slice's share of the
loss, and the gradient of every parameter is then the sum of the ranks'
gradients over the whole mesh.  Adam is ``torch.optim.Adam`` (its default
implementation) in every rank, on the same summed gradients, so the
parameters stay replicated.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from resnet_accel_tpu_torch.ops.flash_attention import fp32_matmuls
from resnet_accel_tpu_torch.parallel.collectives import (axis_index,
                                                         axis_size, psum)
from resnet_accel_tpu_torch.parallel.mesh import batch_sharding, named_mesh
from resnet_accel_tpu_torch.parallel.pipeline import (_mnist_parts,
                                                      run_pipeline)
from resnet_accel_tpu_torch.runtime.backend import resolve_device

AXES = ("dp", "pp", "tp")


def make_combined_mesh(dp: int = 2, pp: int = 2, tp: int = 2,
                       device="cuda"):
    """A ``("dp", "pp", "tp")`` mesh over the world's first dp*pp*tp
    ranks (``None`` on the others)."""
    return named_mesh({"dp": dp, "pp": pp, "tp": tp}, device)


def _check_mesh(mesh: DeviceMesh, tp_feat: int = 128):
    for ax in AXES:
        if ax not in (mesh.mesh_dim_names or ()):
            raise ValueError(f"mesh must have a '{ax}' axis")
    if axis_size(mesh, "pp") != 2:
        raise ValueError("the MNIST CNN splits into exactly 2 pipeline "
                         f"stages; pp={axis_size(mesh, 'pp')}")
    if tp_feat % axis_size(mesh, "tp"):
        raise ValueError(f"tp={axis_size(mesh, 'tp')} must divide the fc1 "
                         f"width {tp_feat}")


def make_combined_forward(mesh: DeviceMesh, microbatch: int = 2):
    """fwd(params, x) -> logits: ``x`` this rank's dp shard [B, 1, 28, 28]
    (B divisible by ``microbatch``), ``params`` the MNIST dict as tensors
    (replicated).  The output is the dp shard's logits, the same on every
    pp and tp rank; it equals the unsharded ``mnist_forward_fp32`` up to
    float summation order (the CNN's stages are row-independent, so the
    microbatches change nothing; tp changes the order of fc2's sum)."""
    _check_mesh(mesh)
    TP = axis_size(mesh, "tp")
    t = axis_index(mesh, "tp")
    last = axis_index(mesh, "pp") == 1
    fp32_matmuls()

    def program(params: Dict[str, torch.Tensor], x: torch.Tensor):
        B = x.shape[0]
        if B % microbatch:
            raise ValueError(f"per-dp batch {B} not divisible by "
                             f"microbatch {microbatch}")
        f1 = params["fc1.weight"].shape[0] // TP       # tp shard width
        w1 = params["fc1.weight"][t * f1:(t + 1) * f1]
        b1 = params["fc1.bias"][t * f1:(t + 1) * f1]
        w2 = params["fc2.weight"][:, t * f1:(t + 1) * f1]
        c1, c2, _, _ = _mnist_parts(params)

        def stage0(mb):                 # conv trunk (replicated weights)
            return c2(c1(mb))

        def stage1(hin):                # tp column -> row parallel head
            a = hin @ w1.T + b1
            a = torch.maximum(a, a.new_zeros(()))
            part = a @ w2.T                             # partial logits
            if last and t == 0:
                part = part + params["fc2.bias"]
            return part

        outs = run_pipeline(mesh, "pp", [stage0, stage1], x, microbatch)
        return psum(outs, mesh, "tp")
    return program


def _mean_ce(logits, y):
    return F.cross_entropy(logits, y.long(), reduction="mean")


def make_combined_train_step(mesh: DeviceMesh, microbatch: int = 2,
                             lr: float = 1e-3, device="cuda"):
    """(init_fn, step_fn, shard_batch): Adam through the dp x pp x tp
    forward.  ``step_fn(params, opt, x, y)`` -> (params, opt, loss) with
    ``x``, ``y`` this rank's dp shard (``shard_batch``); ``loss`` is the
    mean over the global batch, the same on every rank."""
    fwd = make_combined_forward(mesh, microbatch)
    dev = resolve_device(device)
    dp = axis_size(mesh, "dp")

    def init_fn(params: Dict[str, np.ndarray]):
        p = {k: torch.tensor(np.asarray(v, np.float32), device=dev,
                             requires_grad=True) for k, v in params.items()}
        return p, torch.optim.Adam(list(p.values()), lr=lr)

    def step_fn(params, opt, x, y):
        opt.zero_grad(set_to_none=False)
        local = _mean_ce(fwd(params, x), y) / dp
        local.backward()
        with torch.no_grad():
            for v in params.values():
                if v.grad is None:      # not used on this rank
                    v.grad = torch.zeros_like(v)
                g = v.grad
                for ax in AXES:
                    g = psum(g, mesh, ax)
                v.grad.copy_(g)
        opt.step()
        loss = psum(local.detach(), mesh, "dp")
        return params, opt, float(loss)

    def shard_batch(x: np.ndarray, y: np.ndarray):
        return (batch_sharding(torch.as_tensor(x, device=dev), mesh),
                batch_sharding(torch.as_tensor(y, device=dev), mesh))

    return init_fn, step_fn, shard_batch
