"""Device meshes over the ranks of a world.

Counterpart of ``resnet_accel_tpu/parallel/mesh.py``.  A JAX ``Mesh``
names the axes of an array of devices, and a ``NamedSharding`` says how an
array lies on them.  Here each device is a rank of the world that
``launch.run_world`` spawned, the mesh is a ``torch.distributed``
``DeviceMesh`` with the same axis names (one process group per axis:
``mesh.get_group("tp")``), and a sharding is a function that gives this
rank its slice of a tensor.

Every rank of the world calls the mesh builders (making a process group is
collective).  A mesh may cover the first ranks only, as a JAX mesh built
from ``devices[:n]``; a rank outside it gets ``None`` and sits the program
out.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from resnet_accel_tpu_torch.parallel.collectives import (axis_index,
                                                         axis_size)
from resnet_accel_tpu_torch.runtime.backend import resolve_device


def named_mesh(axes: Dict[str, int], device="cuda") -> Optional[DeviceMesh]:
    """A mesh of the world's first ``prod(axes)`` ranks, shaped and named
    by ``axes`` (in order, e.g. ``{"dp": 2, "tp": 2}``); ``None`` on a rank
    outside it."""
    shape = tuple(int(n) for n in axes.values())
    n = math.prod(shape)
    world = dist.get_world_size()
    if n > world:
        dims = "x".join(map(str, shape))
        raise ValueError(f"mesh {dims} needs {n} devices, have {world}")
    mesh = DeviceMesh(resolve_device(device).type,
                      torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))
    return mesh if dist.get_rank() < n else None


def make_mesh(dp: Optional[int] = None, tp: int = 1,
              device="cuda") -> Optional[DeviceMesh]:
    """A ``("dp", "tp")`` mesh over the world's ranks; ``dp`` defaults to
    ``world // tp`` (the JAX package's checks and messages)."""
    n = dist.get_world_size()
    if dp is None:
        if n % tp:
            raise ValueError(f"{n} devices not divisible by tp={tp}")
        dp = n // tp
    if dp * tp > n:
        raise ValueError(f"mesh {dp}x{tp} needs {dp * tp} devices, "
                         f"have {n}")
    return named_mesh({"dp": dp, "tp": tp}, device)


def _shard(t: torch.Tensor, mesh: DeviceMesh, axis: str,
           dim: int = 0) -> torch.Tensor:
    n = axis_size(mesh, axis)
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {t.shape[dim]} not divisible "
                         f"by the '{axis}' axis ({n})")
    per = t.shape[dim] // n
    return t.narrow(dim, axis_index(mesh, axis) * per, per)


def batch_sharding(x: torch.Tensor, mesh: DeviceMesh,
                   axis: str = "dp") -> torch.Tensor:
    """This rank's slice of ``x``'s leading (batch) dim over ``axis``."""
    return _shard(x, mesh, axis)


def replicated(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """``x`` whole on every rank of ``mesh`` (each rank holds its copy)."""
    return x


def tp_row_sharding(w: torch.Tensor, mesh: DeviceMesh,
                    axis: str = "tp") -> torch.Tensor:
    """This rank's rows of a ``[out_features, ...]`` weight over
    ``axis``."""
    return _shard(w, mesh, axis)
