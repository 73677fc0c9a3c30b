"""Pipeline parallelism: GPipe-style staged execution over a ``pp`` axis.

Counterpart of ``resnet_accel_tpu/parallel/pipeline.py``.  A model split
into a list of stages, one a rank of the ``pp`` axis; microbatches stream
through the pipe: at step t, rank r runs stage r on microbatch t - r while
its neighbours work on the adjacent ones, and the activations move one hop
down the pipe by ``ppermute``.  Every rank runs the same loop, as the JAX
program does: ``M + S - 1`` steps for M microbatches and S stages, each
hop in a fixed-size buffer as wide as the widest inter-stage tensor, the
last stage's outputs made replicated by a masked ``psum`` at the end.  The
inter-stage shapes (``jax.eval_shape`` in the JAX program) are found once
a call: each rank runs its stage on zeros of its input's shape, which a
small header brings down the pipe, and the headers are gathered.

The loop differentiates: ``ppermute``'s backward sends each cotangent back
along the reverse hop, and each step's output is tied to the buffer it was
handed (``_tie``, no arithmetic), so that every rank's backward meets the
reverse hops in the same order, step by step (``combined``'s train step).

SEMANTICS CAVEAT (the JAX module's): each stage sees one MICROBATCH at a
time, so the pipelined forward equals the unsharded stack only for stages
that act row-independently (the MNIST CNN does).  Stages that mix rows --
the transformer blocks attend across the microbatch axis and pick dynamic
quantization scales per call -- give outputs that depend on the
microbatch size.  Pick ``microbatch`` as a model choice, not a throughput
knob.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from resnet_accel_tpu_torch.parallel.collectives import (_exchange,
                                                         all_gather,
                                                         axis_index,
                                                         axis_size,
                                                         ppermute, psum)
from resnet_accel_tpu_torch.parallel.heads import _need_axis


class _Tie(torch.autograd.Function):
    """``y`` unchanged, with ``anchor`` as a second input whose gradient is
    zero: keeps ``anchor``'s producer in the backward graph of every
    rank."""

    @staticmethod
    def forward(ctx, y, anchor):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return g, torch.zeros((), dtype=g.dtype, device=g.device)


def _tie(y, anchor):
    if torch.is_grad_enabled() and (y.requires_grad or anchor.requires_grad):
        return _Tie.apply(y, anchor.sum() if anchor.numel() else anchor)
    return y


#: dtypes an inter-stage activation may have, by code in a shape header
_DTYPES = (torch.float32, torch.float64, torch.float16, torch.bfloat16,
           torch.int8, torch.int32, torch.int64)
_MAX_DIMS = 8


def _stage_shapes(mesh: DeviceMesh, axis: str, stages: Sequence[Callable],
                  mb_shape, dtype, device):
    """Each stage's output shape and dtype for a microbatch of
    ``mb_shape``: rank r learns its input's from rank r - 1 (a small
    header hops down the pipe), runs its stage once on zeros of it to see
    its output's, and the headers are gathered over the axis, so that
    every rank knows every hop's width."""
    r, S = axis_index(mesh, axis), axis_size(mesh, axis)

    def header(shape, dt):
        h = torch.zeros(2 + _MAX_DIMS, dtype=torch.int64, device=device)
        h[0], h[1] = len(shape), _DTYPES.index(dt)
        h[2:2 + len(shape)] = torch.tensor(shape)
        return h

    def parse(h):
        h = h.tolist()
        return tuple(h[2:2 + h[0]]), _DTYPES[h[1]]

    if r == 0:
        in_shape, in_dtype = tuple(mb_shape), dtype
    else:
        in_shape, in_dtype = parse(_exchange(header((), dtype), mesh, axis,
                                             [], [r - 1]))
    with torch.no_grad():
        y = stages[r](torch.zeros(in_shape, dtype=in_dtype, device=device))
    out = header(tuple(y.shape), y.dtype)
    if r < S - 1:
        _exchange(out, mesh, axis, [r + 1], [])
    gathered = all_gather(out, mesh, axis, dim=0, tiled=False)
    return [(tuple(mb_shape), dtype)] + [parse(h) for h in gathered]


def run_pipeline(mesh: DeviceMesh, axis: str, stages: Sequence[Callable],
                 x: torch.Tensor, microbatch: int) -> torch.Tensor:
    """The GPipe loop of one rank: ``x`` the whole batch (every rank gets
    it), returns the last stage's output for it on every rank of
    ``axis``."""
    r, S = axis_index(mesh, axis), axis_size(mesh, axis)
    B = x.shape[0]
    if B % microbatch:
        raise ValueError(f"batch {B} not divisible by microbatch "
                         f"{microbatch}")
    M = B // microbatch
    shapes = _stage_shapes(mesh, axis, stages,
                           (microbatch,) + tuple(x.shape[1:]), x.dtype,
                           x.device)
    dtypes = {d for _, d in shapes[1:]}
    if len(dtypes) != 1:
        raise ValueError(
            f"stages must share one activation dtype, got {dtypes}")
    dtype = dtypes.pop()
    widths = [math.prod(s[1:]) for s, _ in shapes]
    bufw = max(widths[1:])
    out_w = widths[-1]
    xs = x.reshape(M, microbatch, *x.shape[1:])
    hop = [(i, i + 1) for i in range(S - 1)]

    buf = torch.zeros((microbatch, bufw), dtype=dtype, device=x.device)
    done: List[torch.Tensor] = []
    n_steps = M + S - 1
    for t in range(n_steps):
        if r == 0:
            xin = xs[min(max(t, 0), M - 1)]
        else:
            xin = buf[:, :widths[r]].reshape(shapes[r][0]).to(shapes[r][1])
        y = stages[r](xin).reshape(microbatch, -1)
        y = _tie(F.pad(y, (0, bufw - widths[r + 1])), buf)
        # the last rank finished microbatch t - (S - 1): record it
        if r == S - 1 and 0 <= t - (S - 1) < M:
            done.append(y[:, :out_w])
        if t < n_steps - 1:
            buf = ppermute(y, mesh, axis, hop) if S > 1 else y
    # outs live on the last rank; the others contribute zeros
    outs = (torch.stack(done) if r == S - 1
            else torch.zeros((M, microbatch, out_w), dtype=dtype,
                             device=x.device))
    outs = _tie(outs, y)
    outs = psum(outs, mesh, axis) if S > 1 else outs
    return outs.reshape((B,) + shapes[-1][0][1:])


def make_pipeline_forward(mesh: DeviceMesh, stages: Sequence[Callable],
                          microbatch: int, axis: str = "pp") -> Callable:
    """An S-stage pipelined forward over mesh axis ``axis``: ``stages`` are
    callables ``stage(x) -> y`` over single tensors, one a rank of the axis.
    Returns ``fwd(x)``: ``x`` the full batch (leading dim a multiple of
    ``microbatch``), the result the last stage's output for it, the same on
    every rank of the axis."""
    stages = list(stages)
    _need_axis(mesh, axis)
    S = axis_size(mesh, axis)
    if len(stages) != S:
        raise ValueError(
            f"{len(stages)} stages for a {S}-deep '{axis}' axis -- "
            "the pipeline needs exactly one stage per rank")

    def fwd(x):
        return run_pipeline(mesh, axis, stages, x, microbatch)
    return fwd


# ======================================================================
# Stage builders for the repo's models
# ======================================================================

def _mnist_parts(p: Dict[str, torch.Tensor]):
    def conv(v, w, b):
        return F.conv2d(v, w) + b[None, :, None, None]

    def relu(v):
        return torch.maximum(v, v.new_zeros(()))

    def s_conv1(x):
        return relu(conv(x, p["conv1.weight"], p["conv1.bias"]))

    def s_conv2_pool(a):
        a = relu(conv(a, p["conv2.weight"], p["conv2.bias"]))
        N, C, H, W = a.shape
        a = a.reshape(N, C, H // 2, 2, W // 2, 2).amax(dim=(3, 5))
        return a.reshape(N, -1)

    def s_fc1(h):
        return relu(h @ p["fc1.weight"].T + p["fc1.bias"])

    def s_fc2(a):
        return a @ p["fc2.weight"].T + p["fc2.bias"]

    return s_conv1, s_conv2_pool, s_fc1, s_fc2


def mnist_pipeline_stages(params: Dict, n_stages: int = 2,
                          device="cuda") -> List[Callable]:
    """The MNIST CNN (conv1 -> conv2 -> 2x2 max pool -> flatten -> fc1 ->
    fc2, float32) split into ``n_stages`` pipeline stages (2, 3 or 4).
    ``params``: numpy arrays (put on ``device``) or tensors (used as they
    are, so that autograd reaches them)."""
    from resnet_accel_tpu_torch.ops.flash_attention import fp32_matmuls
    from resnet_accel_tpu_torch.runtime.backend import resolve_device
    fp32_matmuls()
    dev = resolve_device(device)
    p = {k: v if isinstance(v, torch.Tensor)
         else torch.from_numpy(np.asarray(v, np.float32)).to(dev)
         for k, v in params.items()}
    c1, c2, f1, f2 = _mnist_parts(p)
    if n_stages == 2:
        return [lambda x: c2(c1(x)), lambda h: f2(f1(h))]
    if n_stages == 3:
        return [lambda x: c2(c1(x)), f1, f2]
    if n_stages == 4:
        return [c1, c2, f1, f2]
    raise ValueError(f"MNIST CNN splits into 2-4 stages, not {n_stages}")


def transformer_pipeline_stages(blocks: Sequence, n_stages: int
                                ) -> List[Callable]:
    """Group a stack of transformer encoder blocks (``block(x) -> x``
    callables, e.g. ``TransformerBlockInt8Module``) into ``n_stages``
    contiguous pipeline stages."""
    blocks = list(blocks)
    if n_stages < 1 or n_stages > len(blocks):
        raise ValueError(
            f"cannot split {len(blocks)} blocks into {n_stages} stages")
    per, extra = divmod(len(blocks), n_stages)
    stages, i = [], 0
    for s in range(n_stages):
        k = per + (1 if s < extra else 0)
        group = tuple(blocks[i:i + k])
        i += k

        def stage(x, _group=group):
            for blk in _group:
                x = blk(x)
            return x

        stages.append(stage)
    return stages
