"""Expert parallelism: MoE experts sharded over an ``ep`` mesh axis.

Counterpart of ``resnet_accel_tpu/parallel/experts.py``.  Each rank holds
E / ep of the experts, contiguously (the point of expert parallelism: the
experts' weights need not fit one device).  Tokens stay replicated: every
rank routes them, runs its LOCAL experts over the token set, masks the
tokens routed to other ranks' experts, and a float ``psum`` over ``ep``
assembles the output.  Each token has exactly one nonzero term in that sum,
so the result equals the single-device block bit for bit.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.distributed.device_mesh import DeviceMesh

from resnet_accel_tpu_torch.models.moe import MoEBlockInt8
from resnet_accel_tpu_torch.parallel.collectives import (axis_index,
                                                         axis_size, psum)


def make_ep_moe_forward(mesh: DeviceMesh, moe: MoEBlockInt8,
                        device="cuda") -> Callable:
    """Expert-parallel forward: fwd(x [T, d_model]) -> [T, d_model], input
    and output replicated; this rank packs and runs only its experts."""
    if "ep" not in (mesh.mesh_dim_names or ()):
        raise ValueError("mesh must have an 'ep' axis")
    ep = axis_size(mesh, "ep")
    E = moe.n_experts
    if E % ep:
        raise ValueError(f"{E} experts not divisible by ep={ep}")
    per_rank = E // ep
    r = axis_index(mesh, "ep")
    local = range(r * per_rank, (r + 1) * per_rank)
    mod = moe.module(device, experts=local)

    @torch.inference_mode()
    def fwd(x):
        x = torch.as_tensor(x, dtype=torch.float32, device=mod.device)
        return psum(mod.masked(x, mod.route(x), local), mesh, "ep")
    return fwd
