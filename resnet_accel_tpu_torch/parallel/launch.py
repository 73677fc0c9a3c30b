"""Spawned worlds of ranks: how the port runs one program on many devices.

Counterpart of the JAX package's device list (``parallel/mesh.py``'s
``available_devices``) and of the virtual CPU devices its tests force.  JAX
runs one program over many devices from one process; PyTorch runs one
process a rank, joined by ``torch.distributed``.  :func:`run_world` spawns
those processes, each rank runs the same function (the SPMD program), and
the ranks' results come back in rank order.

- Ranks start with the ``spawn`` method: ``fork`` is not safe once CUDA is
  up in the parent.
- They meet through a ``FileStore`` in a fresh temporary directory, so two
  worlds on one host (two test workers, say) cannot collide on a TCP port.
- Each rank calls ``torch.set_num_threads(1)``, selects its card where the
  world runs on CUDA, and calls ``fn(rank, world, *args)``: ``fn`` must be
  a module-level function of the port, so that it pickles by name and a
  child imports only the port.  Its result must pickle without the card
  (numpy arrays, Python values).
- The parent joins with a time limit.  On a timeout, or when a rank raises,
  it kills the whole world and raises with that rank's traceback; it never
  returns a partial result.
- The backend is the caller's to name: ``nccl`` needs a card a rank;
  ``gloo`` takes CPU tensors, and CUDA tensors for its reductions,
  gathers and broadcasts, so ranks may share one card over it.  There is
  no swap from one to the other.  ``device="cpu"`` runs gloo on the CPU.
- The kernels (``_kernels``) and the native host library (``native``) are
  built in the parent before the spawn: their build locks hold within a
  process only, and a world of four would otherwise run ``nvcc`` four
  times.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch

from resnet_accel_tpu_torch.runtime.backend import resolve_device

BACKENDS = ("gloo", "nccl")


def default_backend(device) -> str:
    """``gloo`` on the CPU, ``nccl`` on CUDA."""
    return "gloo" if resolve_device(device).type == "cpu" else "nccl"


def available_devices(device="cuda") -> int:
    """The devices of ``device``'s kind: the cards (NCCL places one rank a
    card; over gloo ranks may share one), or the CPU's cores."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return os.cpu_count() or 1
    return torch.cuda.device_count()


def _check_backend(dev: torch.device, backend: str, world_size: int) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("nccl runs on CUDA only; the CPU takes gloo")
        cards = torch.cuda.device_count()
        if world_size > cards:
            raise ValueError(f"nccl needs a card a rank: {world_size} "
                             f"ranks, {cards} cards (ranks may share a "
                             f"card over gloo)")


def _rank_main(rank: int, world: int, backend: str, device: str,
               workdir: str, timeout_s: float) -> None:
    """One rank: join the world, run the function, write its result (or
    its traceback) where the parent reads it."""
    import torch.distributed as dist
    try:
        torch.set_num_threads(1)
        with open(os.path.join(workdir, "call.pkl"), "rb") as f:
            fn, args = pickle.load(f)
        # One host: the loopback carries every connection of the world.
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        store = dist.FileStore(os.path.join(workdir, "store"), world)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        out = fn(rank, world, *args)
        tmp = os.path.join(workdir, f"result-{rank}.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(out, f)
        os.replace(tmp, os.path.join(workdir, f"result-{rank}.pkl"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(workdir, f"error-{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        # a peer may be blocked in a collective with this rank: leave
        # without tearing the group down; the parent kills the world
        os._exit(1)


def _read_errors(workdir: str, world: int) -> List[str]:
    errs = []
    for r in range(world):
        path = os.path.join(workdir, f"error-{r}.txt")
        if os.path.exists(path):
            with open(path) as f:
                errs.append(f"rank {r}:\n{f.read()}")
    return errs


def run_world(fn: Callable, world_size: int, *, device="cuda",
              backend: Optional[str] = None, args: Sequence = (),
              timeout_s: float = 120.0) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned ranks
    on ``device`` joined over ``backend`` (default :func:`default_backend`);
    returns the ranks' results in rank order.  Raises, with the failing
    rank's traceback, if a rank raises or dies, or if the world has not
    finished in ``timeout_s`` seconds; every rank is then killed."""
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    dev = resolve_device(device)
    backend = default_backend(dev) if backend is None else backend
    _check_backend(dev, backend, world_size)
    if dev.type == "cuda":
        from resnet_accel_tpu_torch import _kernels, native
        _kernels.build()
        native.build()
    ctx = multiprocessing.get_context("spawn")
    workdir = tempfile.mkdtemp(prefix="world-")
    # the function and its arguments go through a file, read by the ranks
    # once they have started: a spawned process takes its own arguments
    # only after importing the parent's main module, one process after
    # the other
    with open(os.path.join(workdir, "call.pkl"), "wb") as f:
        pickle.dump((fn, tuple(args)), f)
    procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                         args=(r, world_size, backend, dev.type, workdir,
                               timeout_s))
             for r in range(world_size)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        failed = None
        while True:
            codes = [p.exitcode for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited with code {codes[bad[0]]}"
                break
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                failed = (f"world of {world_size} ranks did not finish in "
                          f"{timeout_s:.0f} s")
                break
            time.sleep(0.01)
        if failed is not None:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join()
            raise RuntimeError("\n".join(
                [f"run_world({fn.__name__}, {world_size}): {failed}"]
                + _read_errors(workdir, world_size)))
        out = []
        for r in range(world_size):
            with open(os.path.join(workdir, f"result-{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            if p.pid is not None:
                p.join()
        shutil.rmtree(workdir, ignore_errors=True)
