"""Rank functions for ``launch.run_world``: the parallel programs as a
rank runs them.

Each job builds its mesh over the world (``mesh.named_mesh``), runs one
program of the package on the inputs it is given and returns numpy
results, gathered so that every rank of the mesh returns the whole answer
(``None`` on a rank outside the mesh).  :func:`run_jobs` runs a list of
them in one world, in order, in every rank (their collectives line up), so
that one spawn serves many programs: the CLI, ``dryrun``, the tests and
``chip_smoke.py`` drive the programs through them.  On a card each job
that serves through the kernels also returns its launch counts, reset just
before it.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from resnet_accel_tpu_torch.parallel.collectives import (all_gather,
                                                         axis_index,
                                                         axis_size, ppermute,
                                                         psum, pmax)
from resnet_accel_tpu_torch.parallel.mesh import (batch_sharding, make_mesh,
                                                  named_mesh)

Job = Tuple[str, Callable, Sequence]


def run_jobs(rank: int, world: int, device: str,
             jobs: Sequence[Job]) -> Dict[str, object]:
    """``{key: fn(rank, world, device, *args)}`` for each ``(key, fn,
    args)`` of ``jobs``, run in order, and under ``"seconds"`` each job's
    time on this rank's host clock (a job on a card ends in a copy to the
    host)."""
    out: Dict[str, object] = {}
    seconds = {}
    for key, fn, args in jobs:
        t0 = time.perf_counter()
        out[key] = fn(rank, world, device, *args)
        seconds[key] = time.perf_counter() - t0
    out["seconds"] = seconds
    return out


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _counted(device, fn):
    """(fn(), the kernels' launch counts during it) on a card; counts None
    on the CPU (the plain versions run there)."""
    if torch.device(device).type != "cuda":
        return fn(), None
    from resnet_accel_tpu_torch import _kernels
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {"launches": _kernels.launch_counts(),
                 "variants": _kernels.variant_counts()}


def raises(rank, world, device, fn: Callable,
           axes: Optional[Dict[str, int]], args: Sequence = (),
           kwargs: Optional[dict] = None, mesh_kw: Optional[str] = None):
    """``fn(mesh, *args, **kwargs)`` on the mesh ``axes`` (the mesh passed
    as the keyword ``mesh_kw`` where that is given; ``fn(*args, **kwargs)``
    where ``axes`` is None); returns the ``ValueError``'s message it raised
    (``"no error"`` if it raised none), ``None`` on a rank outside the
    mesh (or where ``fn`` returned None: a rank function that sat out)."""
    lead, kwargs = (), dict(kwargs or {})
    if axes is not None:
        mesh = named_mesh(axes, device)
        if mesh is None:
            return None
        if mesh_kw is None:
            lead = (mesh,)
        else:
            kwargs[mesh_kw] = mesh
    try:
        out = fn(*lead, *args, **kwargs)
    except ValueError as e:
        return str(e)
    return None if out is None else "no error"


# ------------------------------------------------------------ the mesh
def mesh_info(rank, world, device, dp=None, tp=1):
    """``make_mesh(dp, tp)``'s axis sizes and this rank's coordinates."""
    mesh = make_mesh(dp, tp, device)
    if mesh is None:
        return None
    return {"shape": {n: axis_size(mesh, n) for n in mesh.mesh_dim_names},
            "coord": tuple(mesh.get_coordinate())}


def collectives_check(rank, world, device):
    """Each collective on a ("dp", "tp") mesh of the world, and the
    gradients of psum, all_gather and ppermute."""
    dev = torch.device(device)
    mesh = make_mesh(tp=2, device=device)
    t, n = axis_index(mesh, "tp"), axis_size(mesh, "tp")
    big = torch.tensor([2 ** 30 + rank], dtype=torch.int32, device=dev)
    x = torch.arange(3, dtype=torch.float32, device=dev) + 10 * rank
    x.requires_grad_(True)
    s = psum(x, mesh, "tp")
    g = all_gather(x, mesh, "tp", dim=0)
    st = all_gather(x, mesh, "tp", dim=0, tiled=False)
    ring = ppermute(x, mesh, "tp", [(i, (i + 1) % n) for i in range(n)])
    hop = ppermute(x, mesh, "tp", [(0, 1)])
    w = torch.arange(1, 4, dtype=torch.float32, device=dev)
    ((s * w).sum() + (g[:3] * 2).sum() + (ring * w).sum()
     + (hop * 3).sum()).backward()
    return {"index": t, "psum_i32": _np(psum(big, mesh, "tp")),
            "psum": _np(s), "pmax": _np(pmax(x, mesh, "tp")),
            "gather": _np(g), "stack": _np(st), "ring": _np(ring),
            "hop": _np(hop), "grad": _np(x.grad),
            "dtype": str(psum(big, mesh, "tp").dtype)}


# ----------------------------------------------------------- sharded
def dp_forward(rank, world, device, model, x: np.ndarray, dp=None,
               iters: int = 0):
    """make_data_parallel_forward over a ("dp", "tp" = 1) mesh: the global
    logits and the launch counts of this rank's served slice.  With
    ``iters`` on a card, also the median over ``iters`` runs of this rank's
    forward of its slice (CUDA events: ``ms_rank``) and of the whole
    program, the all-gather included (host clock: ``ms_whole``)."""
    from resnet_accel_tpu_torch.parallel.sharded import \
        make_data_parallel_forward
    mesh = make_mesh(dp=dp, tp=1, device=device)
    if mesh is None:
        return None
    fwd, mod, put = make_data_parallel_forward(model, mesh, device)
    xb = put(x)
    out, counts = _counted(device, lambda: fwd(mod, xb))
    res = {"logits": _np(out), "counts": counts, "rows": xb.shape[0]}
    if iters and torch.device(device).type == "cuda":
        res["ms_rank"], res["ms_whole"] = _dp_times(fwd, mod, xb, iters)
    return res


def _dp_times(fwd, mod, xb, iters):
    rank_ms, whole_ms = [], []
    with torch.inference_mode():
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            mod(xb)
            end.record()
            end.synchronize()
            rank_ms.append(start.elapsed_time(end))
            t0 = time.perf_counter()
            fwd(mod, xb)
            torch.cuda.synchronize()
            whole_ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(rank_ms)), float(np.median(whole_ms))


def dp_bsr(rank, world, device, bsr, a: np.ndarray, dp=None):
    """make_dp_bsr_matmul over a ("dp", "tp" = 1) mesh."""
    from resnet_accel_tpu_torch.parallel.sharded import make_dp_bsr_matmul
    mesh = make_mesh(dp=dp, tp=1, device=device)
    if mesh is None:
        return None
    fwd = make_dp_bsr_matmul(mesh, bsr, device)
    out, counts = _counted(device, lambda: fwd(a))
    return {"out": _np(out), "counts": counts}


def _full_params(params, mesh, split):
    return {k: _np(all_gather(v.detach(), mesh, "tp", dim=0) if split[k]
                   else v) for k, v in params.items()}


def sharded_train(rank, world, device, dp, tp, params, x, y, steps=1,
                  lr=1e-3):
    """``steps`` Adam steps of make_sharded_train_step: the losses and the
    parameters after (fc1 gathered over tp)."""
    from resnet_accel_tpu_torch.parallel.sharded import (
        _param_shardings, make_sharded_train_step)
    mesh = make_mesh(dp, tp, device)
    if mesh is None:
        return None
    init_fn, step_fn, shard_batch = make_sharded_train_step(mesh, lr,
                                                            device)
    p, opt = init_fn(params)
    xs, ys = shard_batch(x, y)
    losses = []
    for _ in range(steps):
        p, opt, loss = step_fn(p, opt, xs, ys)
        losses.append(loss)
    return {"losses": losses, "fc1_rows": tuple(p["fc1.weight"].shape),
            "params": _full_params(p, mesh, _param_shardings(p))}


# ------------------------------------------------------------- heads
def tp_forward(rank, world, device, axes, block, x):
    from resnet_accel_tpu_torch.parallel.heads import \
        make_tp_transformer_forward
    mesh = named_mesh(axes, device)
    if mesh is None:
        return None
    return _np(make_tp_transformer_forward(mesh, block, device)(x))


def tp_decode(rank, world, device, axes, block, scales, x_seq, max_len):
    """make_tp_decode_step over x_seq's rows one at a time: each step's
    output and the K cache after it, gathered over tp."""
    from resnet_accel_tpu_torch.parallel.heads import make_tp_decode_step
    mesh = named_mesh(axes, device)
    if mesh is None:
        return None
    init, step = make_tp_decode_step(mesh, block, scales, max_len, device)
    cache = init()
    ys, ks = [], []
    for t in range(len(x_seq)):
        y, cache = step(cache, x_seq[t:t + 1])
        ys.append(_np(y))
        ks.append(_np(all_gather(cache["k"], mesh, "tp", dim=1)))
    return {"y": np.stack(ys), "k": np.stack(ks), "len": cache["len"],
            "k_local": tuple(cache["k"].shape)}


def tp_generate(rank, world, device, axes, lm, scales, prompt, n_new,
                batched=False):
    from resnet_accel_tpu_torch.parallel.heads import make_tp_lm_generate
    mesh = named_mesh(axes, device)
    if mesh is None:
        return None
    gen = make_tp_lm_generate(mesh, lm, scales, n_new, batched=batched,
                              device=device)
    return gen(prompt)


def paged_tp(rank, world, device, axes, lm, scales, rounds, engine,
             score=None):
    """PagedKVBatcher(tp_mesh=...) with ``engine`` arguments: each round of
    (prompt, n_new, seed) requests submitted and drained in turn; returns
    the streams (by round, in submission order), the counters, the pool
    bytes, the rank's pool slice width and, with ``score``, ``score()`` of
    those sequences."""
    from resnet_accel_tpu_torch.runtime.paged import PagedKVBatcher
    mesh = named_mesh(axes, device)
    if mesh is None:
        return None
    eng = PagedKVBatcher(lm, scales, tp_mesh=mesh, device=device,
                         **engine)
    streams = []
    t0 = time.perf_counter()
    for reqs in rounds:
        rids = [eng.submit(p, n, seed=s) for p, n, s in reqs]
        res = eng.run()
        streams.append([res[r] for r in rids])
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out = {"streams": streams, "seconds": dt,
           "counters": {k: getattr(eng, k) for k in (
               "steps", "micro_steps", "preemptions", "cache_hits",
               "cache_tokens_skipped", "spec_switches")},
           "pool_bytes": eng.kv_pool_bytes(),
           "slice": tuple(eng._pool_k["q"].shape if isinstance(
               eng._pool_k, dict) else eng._pool_k.shape),
           "free": eng.free_pages()}
    if score is not None:
        out["score"] = eng.score(score)
    return out


# ------------------------------------------------- sequence, experts
def sp_forward(rank, world, device, axes, block, x):
    """make_sp_transformer_forward on this rank's token shard of ``x``;
    the output gathered over sp."""
    from resnet_accel_tpu_torch.parallel.sequence import \
        make_sp_transformer_forward
    mesh = named_mesh(axes, device)
    if mesh is None:
        return None
    fwd = make_sp_transformer_forward(mesh, block, device)
    xs = batch_sharding(torch.as_tensor(x), mesh, "sp")
    return _np(all_gather(fwd(xs), mesh, "sp", dim=0))


def ep_forward(rank, world, device, axes, moe, x):
    from resnet_accel_tpu_torch.parallel.experts import make_ep_moe_forward
    mesh = named_mesh(axes, device)
    if mesh is None:
        return None
    return _np(make_ep_moe_forward(mesh, moe, device)(x))


# ---------------------------------------------------------- pipeline
def _stages(kind, payload, depth, device):
    from resnet_accel_tpu_torch.parallel.pipeline import (
        mnist_pipeline_stages, transformer_pipeline_stages)
    if kind == "mnist":
        return mnist_pipeline_stages(payload, depth, device)
    from resnet_accel_tpu_torch.models.transformer import \
        TransformerBlockInt8Module
    mods = [TransformerBlockInt8Module(b, device) for b in payload]
    return transformer_pipeline_stages(mods, depth)


def pipeline_forward(rank, world, device, axes, kind, payload, depth,
                     microbatch, x, grad=False):
    """make_pipeline_forward over ``kind``'s stages ("mnist": the CNN's
    params; "transformer": a list of blocks) on the axis "pp" of ``axes``;
    with ``grad``, also d sum(out) / dx through the pipe."""
    from resnet_accel_tpu_torch.parallel.pipeline import \
        make_pipeline_forward
    mesh = named_mesh(axes, device)
    if mesh is None:
        return None
    fwd = make_pipeline_forward(mesh, _stages(kind, payload, depth, device),
                                microbatch)
    xt = torch.as_tensor(x, device=device)
    if not grad:
        with torch.inference_mode():
            return _np(fwd(xt))
    xt = xt.clone().requires_grad_(True)
    out = fwd(xt)
    out.sum().backward()
    # x is replicated: its gradient is the sum of the ranks' (only the
    # first stage reads it)
    g = xt.grad if xt.grad is not None else torch.zeros_like(xt)
    return {"out": _np(out), "grad": _np(psum(g, mesh, "pp"))}


def combined_forward(rank, world, device, axes, params, x, microbatch=2):
    """make_combined_forward on this rank's dp shard; logits gathered over
    dp."""
    from resnet_accel_tpu_torch.parallel.combined import \
        make_combined_forward
    mesh = named_mesh(axes, device)
    if mesh is None:
        return None
    fwd = make_combined_forward(mesh, microbatch)
    p = {k: torch.as_tensor(v, device=device) for k, v in params.items()}
    xs = batch_sharding(torch.as_tensor(x, device=device), mesh)
    with torch.inference_mode():
        return _np(all_gather(fwd(p, xs), mesh, "dp", dim=0))


def combined_train(rank, world, device, axes, params, x, y, steps=1,
                   microbatch=2, lr=1e-3):
    from resnet_accel_tpu_torch.parallel.combined import \
        make_combined_train_step
    mesh = named_mesh(axes, device)
    if mesh is None:
        return None
    init_fn, step_fn, shard_batch = make_combined_train_step(
        mesh, microbatch, lr, device)
    p, opt = init_fn(params)
    xs, ys = shard_batch(x, y)
    losses = []
    for _ in range(steps):
        p, opt, loss = step_fn(p, opt, xs, ys)
        losses.append(loss)
    return {"losses": losses, "params": {k: _np(v) for k, v in p.items()}}


def world_info(rank, world, device) -> Dict:
    """The rank, the world's backend and the device the rank runs on."""
    import torch.distributed as dist
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return {"rank": rank, "world": world, "backend": dist.get_backend(),
            "device": str(dev)}

