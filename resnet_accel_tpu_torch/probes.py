"""Rate and ablation probes on the card: the counterparts of the TPU
experiments under ``tools/`` that reach ``pl.pallas_call``.

They measure, they serve nothing.  ``csrc/probes.cu`` holds the kernels;
each launcher here takes CUDA tensors (there is no probe on the CPU apart
from the plain versions, which hold the launchers' outputs right on the
card) and each ``*_rate`` function times them with a ``timer(fn, iters) ->
ms`` the caller gives (``chip_smoke.py``'s CUDA-event timer):

- :func:`mma_s8_rate` (``tools/dot_probe.py::bench_one``,
  ``mosaic_probe.py::bench_dot_shapes``, ``stem_dot_probe.py::dot_kernel``):
  chained ``mma.sync`` m16n8k32 int8 dots at an M x 64 x K block tile,
  operands in shared memory; TOP/s from the slope between two chain
  lengths, so staging and launch drop out.
- :func:`chain_rate` (``stem_dot_probe.py::vpu_kernel``): dependent
  chains of int32 ``max`` and of the f32 requant step, steps/s.
- :func:`stem_ablation` (``stem_stage_probe.py::main``,
  ``stem_ring_probe.py``'s ``epilogue_cost`` and ``staging_cost``): the
  stem's tensor-core tile (``csrc/stem_mma_tile.cuh``, K1's and K10's)
  pooled on K1's fp32 inputs, with stages knocked out.
- :func:`tma_box` (no TPU counterpart; K4's small-block path rests on
  it): one TMA tiled load of a 16-byte x 128-row box at an inner
  coordinate ``x``.  Equal to :func:`tma_box_plain` where ``x`` is a
  multiple of 16; off 16 bytes the H100 faults with an illegal
  instruction, which poisons the process's CUDA context, so a caller
  tries such an ``x`` in a process of its own.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict

import numpy as np
import torch

from resnet_accel_tpu_torch import _kernels
from resnet_accel_tpu_torch.ops.stem_fused import (STEM_OUT, stem_out_hw,
                                                   stem_packed, stem_plan)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float

#: The tile's width (N) of the dot probe.
MMA_N = 64
#: The stem tile's stages a probe keeps (``stem_mma::Mode`` in
#: ``csrc/stem_mma_tile.cuh``): everything; the staging alone; all but
#: the input's loads; the unpooled epilogue (a requant of each conv value
#: into an int8 tile) in place of the int32 conv tile and the pool.
STEM_MODES = {"full": 0, "stage_only": 1, "no_loads": 2, "no_pool": 3}
#: Chain kinds of :func:`chain`: int32 ``v = max(v, u + c)``; the f32
#: requant step ``clamp(rint(f * m), lo, hi)``.
CHAIN_KINDS = {"int32_max": 0, "f32_requant": 1}

Timer = Callable[[Callable[[], object], int], float]


def _cuda(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the probes run on a card, got {t.device}")


def mma_s8(a: torch.Tensor, b: torch.Tensor, reps: int,
           blocks: int) -> torch.Tensor:
    """``blocks`` copies of reps x (a @ b^T), int32 [blocks, M, 64], each
    computed by one block of chained ``mma.sync``: a [M, K] int8 (M 64 or
    128), b [64, K] int8, K % 32 == 0."""
    _cuda(a, "mma_s8")
    M, K = a.shape
    if M not in (64, 128) or K % 32 or tuple(b.shape) != (MMA_N, K):
        raise ValueError(f"mma_s8 takes a [64 or 128, K] and b [64, K] "
                         f"with K % 32 == 0, got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    dev = a.device
    _kernels.check(a, "a", torch.int8, (M, K), dev)
    _kernels.check(b, "b", torch.int8, (MMA_N, K), dev)
    out = torch.empty((blocks, M, MMA_N), dtype=torch.int32, device=dev)
    _kernels.launch_probe("mma_rate_launch", [_P] * 3 + [_I] * 4, dev,
                          a.data_ptr(), b.data_ptr(), out.data_ptr(), M, K,
                          reps, blocks)
    return out


def mma_s8_plain(a: torch.Tensor, b: torch.Tensor, reps: int,
                 blocks: int) -> torch.Tensor:
    """Plain version of :func:`mma_s8`, exact in float64 while the sums
    stay inside int32."""
    c = reps * (a.to(torch.float64) @ b.to(torch.float64).t())
    return c.to(torch.int32).unsqueeze(0).expand(blocks, -1, -1)


def chain(x: torch.Tensor, n: int, kind: str, c: int = -1,
          m: float = 1.0001, lo: float = -128.0,
          hi: float = 127.0) -> torch.Tensor:
    """``n`` steps of four dependent chains a thread from ``x`` [threads,
    4] int32 (threads a multiple of 256) -> [threads] int32, the sum of
    each thread's chains; ``kind`` as :data:`CHAIN_KINDS`."""
    _cuda(x, "chain")
    T = x.shape[0]
    if T % 256:
        raise ValueError(f"chain takes a multiple of 256 threads, got {T}")
    dev = x.device
    _kernels.check(x, "x", torch.int32, (T, 4), dev)
    out = torch.empty(T, dtype=torch.int32, device=dev)
    _kernels.launch_probe("chain_launch", [_P] * 2 + [_I] * 4 + [_F] * 3,
                          dev, x.data_ptr(), out.data_ptr(), T, n,
                          CHAIN_KINDS[kind], c, m, lo, hi)
    return out


def chain_plain(x: torch.Tensor, n: int, kind: str, c: int = -1,
                m: float = 1.0001, lo: float = -128.0,
                hi: float = 127.0) -> torch.Tensor:
    """Plain version of :func:`chain`: the same steps in the same order,
    each float step one float32 operation."""
    if kind == "f32_requant":
        v = [x[:, i].to(torch.float32) for i in range(4)]
        mt = torch.tensor(m, dtype=torch.float32, device=x.device)
        for _ in range(n):
            for i in range(4):
                v[i] = torch.round(v[(i + 1) % 4] * mt).clamp(lo, hi)
        return sum(t.to(torch.int32) for t in v).to(torch.int32)
    v = [x[:, i].clone() for i in range(4)]
    for _ in range(n):
        for i in range(4):
            v[i] = torch.maximum(v[i], v[(i + 1) % 4] + c)
    return sum(v).to(torch.int32)


def stem_ablation(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  factors: torch.Tensor, scale: float,
                  mode: str) -> torch.Tensor:
    """The stem tile, pooled on fp32 input, on ``stem_conv_pool``'s
    arguments (either weight) with the stages of ``mode``
    (:data:`STEM_MODES`) only; "full" computes K1's output, the others are
    for their time alone."""
    _cuda(x, "stem_ablation")
    N, _, H, W = x.shape
    Hp, Wp = stem_out_hw(H, W)
    dev = x.device
    _kernels.check(x, "x", torch.float32, (N, 3, H, W), dev)
    weight = stem_packed(weight, dev)
    out = torch.empty((N, STEM_OUT, Hp, Wp), dtype=torch.int8, device=dev,
                      memory_format=torch.channels_last)
    tiles, ctas = stem_plan(N, H, W, _kernels.sm_count(dev))
    if tiles == 0:
        return out
    _kernels.launch_probe(
        "stem_probe_launch", [_P] * 5 + [_I] * 6 + [_F, _I], dev,
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), factors.data_ptr(),
        out.data_ptr(), N, H, W, Hp, Wp, ctas, float(scale),
        STEM_MODES[mode])
    return out


def _slope_ms(timer: Timer, run, n1: int, n2: int, iters: int) -> float:
    """Device ms per unit of ``run(n)``'s work, from two lengths."""
    return (timer(lambda: run(n2), iters) - timer(lambda: run(n1), iters)) \
        / (n2 - n1)


def mma_s8_rate(M: int, K: int, device: torch.device, timer: Timer,
                reps=(32, 288), iters: int = 5) -> Dict[str, float]:
    """TOP/s of chained ``mma.sync`` int8 dots at an M x 64 x K tile,
    eight blocks an SM; the result is held against its plain version
    first.  Returns ``tops``, ``ns_per_dot`` (one block's tile product)
    and ``blocks``."""
    rng = np.random.default_rng(M + K)
    a = torch.from_numpy(rng.integers(-4, 4, (M, K)).astype(np.int8)).to(
        device)
    b = torch.from_numpy(rng.integers(-4, 4, (MMA_N, K)).astype(
        np.int8)).to(device)
    blocks = 8 * torch.cuda.get_device_properties(device).multi_processor_count
    if not torch.equal(mma_s8(a, b, 3, blocks),
                       mma_s8_plain(a, b, 3, blocks)):
        raise RuntimeError(f"mma_s8 at M {M} K {K} differs from its plain "
                           f"version")
    per_rep = _slope_ms(timer, lambda r: mma_s8(a, b, r, blocks), *reps,
                        iters)
    ops = 2 * M * MMA_N * K * blocks
    return {"tops": ops / (per_rep * 1e-3) / 1e12,
            "ns_per_dot": per_rep * 1e6, "blocks": blocks}


def chain_rate(kind: str, device: torch.device, timer: Timer,
               steps=(256, 2304), iters: int = 5) -> Dict[str, float]:
    """Chain steps per second over the whole card (2048 threads an SM,
    four chains each); the result is held against its plain version
    first.  Returns ``steps_per_s`` and ``threads``."""
    threads = 2048 * torch.cuda.get_device_properties(
        device).multi_processor_count
    x = torch.from_numpy(np.random.default_rng(5).integers(
        -100, 100, (threads, 4)).astype(np.int32)).to(device)
    if not torch.equal(chain(x, 8, kind), chain_plain(x, 8, kind)):
        raise RuntimeError(f"chain {kind} differs from its plain version")
    per_step = _slope_ms(timer, lambda n: chain(x, n, kind), *steps, iters)
    return {"steps_per_s": 4 * threads / (per_step * 1e-3),
            "threads": threads}


#: The box :func:`tma_box` loads: 16 bytes of K by 128 rows.
TMA_BOX = (128, 16)


def tma_box(a: torch.Tensor, x: int) -> torch.Tensor:
    """The TMA box of int8 ``a`` [M, K] (K % 16 == 0) at (x, 0): [128, 16]
    int8, zero past K and M, as TMA loads it into shared memory."""
    _cuda(a, "tma_box")
    M, K = a.shape
    if K % 16:
        raise ValueError(f"tma_box needs K % 16 == 0, got K = {K}")
    dev = a.device
    _kernels.check(a, "a", torch.int8, (M, K), dev)
    out = torch.empty(TMA_BOX, dtype=torch.int8, device=dev)
    _kernels.launch_probe("tma_box_launch", [_P] * 2 + [_I] * 3, dev,
                          a.data_ptr(), out.data_ptr(), M, K, x)
    return out


def tma_box_plain(a: torch.Tensor, x: int) -> torch.Tensor:
    """Plain version of :func:`tma_box`."""
    out = torch.zeros(TMA_BOX, dtype=torch.int8, device=a.device)
    part = a[:TMA_BOX[0], x:x + TMA_BOX[1]]
    out[:part.shape[0], :part.shape[1]] = part
    return out
