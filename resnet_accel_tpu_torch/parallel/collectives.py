"""Collectives over one named axis of a mesh.

Counterparts of the ``jax.lax`` collectives the JAX programs call inside
``shard_map``: ``axis_index``, ``psum``, ``pmax``, ``all_gather`` and
``ppermute``, each over the process group of one axis of a
``DeviceMesh`` (``mesh.get_group(axis)``).  They return new tensors and
leave their inputs as they were.

- ``psum`` keeps its dtype: an int32 sum stays int32, as the tensor-
  parallel programs reduce int32 accumulators before they dequantize.
- ``psum``, ``all_gather`` and ``ppermute`` are ``torch.autograd``
  functions whose backward is the transpose JAX takes inside a program
  that holds a replicated value's cotangent whole on every rank: the
  cotangent of a ``psum`` passes through unchanged, an ``all_gather``
  hands each rank back its own slice of it, and a ``ppermute`` sends it
  back along the reverse hop.  The training programs (``sharded``,
  ``combined``) differentiate through them.
- Over gloo a CUDA tensor can be reduced, gathered and broadcast, but not
  sent or received point to point: there ``ppermute`` copies the hop
  through the host, the compute stays on the card.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.get_local_rank(mesh_dim=axis)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The number of ranks along ``axis``."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _global_rank(mesh: DeviceMesh, axis: str, index: int) -> int:
    """The world rank at ``index`` along ``axis``, this rank's coordinates
    elsewhere."""
    coord = list(mesh.get_coordinate())
    coord[mesh.mesh_dim_names.index(axis)] = index
    return int(mesh.mesh[tuple(coord)])


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis``, in ``x``'s dtype."""
    return _PSum.apply(x, mesh.get_group(mesh_dim=axis))


def pmax(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the ranks of ``axis``."""
    y = x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX,
                    group=mesh.get_group(mesh_dim=axis))
    return y


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, index, dim, tiled):
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        ctx.index, ctx.dim, ctx.tiled = index, dim, tiled
        ctx.size = x.shape[dim] if tiled else None
        return torch.cat(parts, dim) if tiled else torch.stack(parts, dim)

    @staticmethod
    def backward(ctx, g):
        own = (g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size)
               if ctx.tiled else g.select(ctx.dim, ctx.index))
        return own, None, None, None, None, None


def all_gather(x: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, in rank order: concatenated along
    ``dim`` (``tiled``) or stacked on a new ``dim``."""
    return _AllGather.apply(x, mesh.get_group(mesh_dim=axis),
                            axis_size(mesh, axis), axis_index(mesh, axis),
                            dim, tiled)


def _exchange(x: torch.Tensor, mesh: DeviceMesh, axis: str,
              send_to: List[int], recv_from: List[int]) -> torch.Tensor:
    """Send ``x`` to the axis indices ``send_to``, receive one tensor of
    ``x``'s shape from ``recv_from`` (zeros where there is none)."""
    group = mesh.get_group(mesh_dim=axis)
    through_host = x.is_cuda and dist.get_backend(group) == "gloo"
    # gloo sends and receives CPU tensors only: the hop goes through the
    # host there
    buf = x.detach()
    if through_host:
        buf = buf.cpu()
    buf = buf.contiguous()
    out = torch.zeros_like(buf)
    works = [dist.irecv(out, src=_global_rank(mesh, axis, s), group=group)
             for s in recv_from]
    works += [dist.isend(buf, dst=_global_rank(mesh, axis, d), group=group)
              for d in send_to]
    for w in works:
        w.wait()
    return out.to(x.device) if through_host else out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, anchor, mesh, axis, pairs):
        me = axis_index(mesh, axis)
        ctx.mesh, ctx.axis, ctx.pairs = mesh, axis, pairs
        return _exchange(x, mesh, axis, [d for s, d in pairs if s == me],
                         [s for s, d in pairs if d == me])

    @staticmethod
    def backward(ctx, g):
        me = axis_index(ctx.mesh, ctx.axis)
        back = _exchange(g, ctx.mesh, ctx.axis,
                         [s for s, d in ctx.pairs if d == me],
                         [d for s, d in ctx.pairs if s == me])
        return back, None, None, None, None


def ppermute(x: torch.Tensor, mesh: DeviceMesh, axis: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``jax.lax.ppermute``: each rank sends ``x`` to the index its
    ``(source, dest)`` pair names and returns what it received, zeros where
    no pair sends to it.  Every rank of the axis calls it with the same
    ``perm``."""
    pairs = tuple((int(s), int(d)) for s, d in perm)
    for i in (0, 1):
        ends = [p[i] for p in pairs]
        if len(set(ends)) != len(ends):
            raise ValueError(f"ppermute: {'sources' if i == 0 else 'dests'}"
                             f" repeat in {list(pairs)}")
    # The hop's backward is itself a hop, a collective: under autograd
    # every rank's hop must join its graph, also where its own input needs
    # no gradient (a pipeline's first stage feeds data, its last receives a
    # value that does): a leaf that wants a gradient makes the output want
    # one on every rank alike.
    anchor = (torch.ones((), requires_grad=True) if torch.is_grad_enabled()
              else None)
    return _PPermute.apply(x, anchor, mesh, axis, pairs)
