"""Performance metrics and timing on the card.

Counterpart of ``resnet_accel_tpu/runtime/perf.py``: ``PerfMetrics`` (the
reference's PerfMetrics: GOPS, utilization, bandwidth, operational
intensity and the roofline side of one measured region), ``LayerProfiler``
and ``PerfTimer``, against the one platform the port runs on, the H100;
``measure_chained`` and ``median_pair_time``, the chained steady-state
basis of ``bench.py``.

Every clock here is CUDA events on a card and the host clock, after a
synchronize, on the CPU.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Platform:
    """One card's roofline constants (public per-card figures)."""

    name: str
    peak_int8_ops: float     # ops/s, int8 tensor cores
    peak_bf16_flops: float   # flops/s
    hbm_bytes_per_s: float
    hbm_bytes: float

    @property
    def ridge_ops_per_byte(self) -> float:
        return self.peak_int8_ops / self.hbm_bytes_per_s


#: NVIDIA's H100 SXM data sheet: dense rates at the 700 W limit.
PLATFORMS: Dict[str, Platform] = {
    "h100": Platform("h100", 1979e12, 989e12, 3.35e12, 80e9),
}


def get_platform(name: Optional[str] = None) -> Platform:
    """The roofline constants of ``name`` (default ``h100``, the only row)."""
    key = (name or "h100").lower()
    if key not in PLATFORMS:
        raise ValueError(
            f"unknown platform {key!r}; known: {sorted(PLATFORMS)}")
    return PLATFORMS[key]


@dataclasses.dataclass
class PerfMetrics:
    """Derived metrics for one measured region."""

    name: str
    latency_s: float
    total_ops: int
    bytes_accessed: int
    iters: int = 1
    platform: Platform = dataclasses.field(default_factory=get_platform)

    @property
    def gops(self) -> float:
        return self.total_ops / self.latency_s / 1e9 if self.latency_s else 0.0

    @property
    def utilization(self) -> float:
        """Fraction of the card's int8 peak achieved."""
        return self.total_ops / self.latency_s / self.platform.peak_int8_ops \
            if self.latency_s else 0.0

    @property
    def bandwidth_gbs(self) -> float:
        return self.bytes_accessed / self.latency_s / 1e9 \
            if self.latency_s else 0.0

    @property
    def operational_intensity(self) -> float:
        """ops/byte: the roofline's x coordinate."""
        return self.total_ops / self.bytes_accessed \
            if self.bytes_accessed else 0.0

    @property
    def roofline_bound(self) -> str:
        """'compute' or 'memory', by the platform's ridge point."""
        ridge = self.platform.ridge_ops_per_byte
        return "compute" if self.operational_intensity >= ridge else "memory"

    @property
    def bound_s(self) -> float:
        """The least time the platform could take for this work."""
        return max(self.total_ops / self.platform.peak_int8_ops,
                   self.bytes_accessed / self.platform.hbm_bytes_per_s)

    def report(self) -> str:
        return (
            f"[{self.name}] {self.latency_s * 1e6:.0f} us | "
            f"{self.gops:.1f} GOPS | util {self.utilization * 100:.1f}% | "
            f"{self.bandwidth_gbs:.1f} GB/s | "
            f"OI {self.operational_intensity:.1f} ops/B "
            f"({self.roofline_bound}-bound)")


def _sync(device: Optional[torch.device]) -> None:
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_of(out) -> Optional[torch.device]:
    """The device of the first tensor in ``out`` (a tensor or a nest of
    lists and tuples), else None."""
    if isinstance(out, torch.Tensor):
        return out.device
    if isinstance(out, (list, tuple)):
        for o in out:
            dev = _device_of(o)
            if dev is not None:
                return dev
    return None


def _elapsed_s(fn: Callable, device: Optional[torch.device]) -> float:
    """Seconds one ``fn()`` takes: CUDA events around it on a card, the
    host clock to a synchronize elsewhere."""
    if device is not None and device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


class PerfTimer:
    """Warm up, then time ``iters`` calls; the best one counts."""

    def __init__(self, warmup: int = 1, iters: int = 10):
        self.warmup = warmup
        self.iters = iters

    def measure(self, name: str, fn: Callable, *args, total_ops: int = 0,
                bytes_accessed: int = 0) -> PerfMetrics:
        out = None
        for _ in range(self.warmup):
            out = fn(*args)
        device = _device_of(out if out is not None else list(args))
        _sync(device)
        best = min(_elapsed_s(lambda: fn(*args), device)
                   for _ in range(self.iters))
        return PerfMetrics(name=name, latency_s=best, total_ops=total_ops,
                           bytes_accessed=bytes_accessed, iters=self.iters)


class LayerProfiler:
    """Per-layer ``PerfMetrics`` of one model run."""

    def __init__(self):
        self.records: List[PerfMetrics] = []

    def add(self, m: PerfMetrics) -> None:
        self.records.append(m)

    def summary(self) -> Dict[str, float]:
        total_t = sum(r.latency_s for r in self.records)
        total_ops = sum(r.total_ops for r in self.records)
        return {
            "total_latency_s": total_t,
            "total_ops": total_ops,
            "overall_gops": total_ops / total_t / 1e9 if total_t else 0.0,
            "layers": len(self.records),
        }

    def report(self) -> str:
        lines = [r.report() for r in self.records]
        s = self.summary()
        lines.append(
            f"[total] {s['total_latency_s'] * 1e6:.0f} us | "
            f"{s['overall_gops']:.1f} GOPS over {s['layers']} layers")
        return "\n".join(lines)


def _chain_s(fn: Callable, x, feedback: Callable, k: int, outer: int,
             device) -> float:
    """Seconds of one pass of ``k`` dependent calls, timed over ``outer``
    passes."""
    def run():
        a = x
        for _ in range(outer):
            for _ in range(k):
                a = feedback(a, fn(a))
        return a
    return _elapsed_s(run, device) / outer


def measure_chained(fn: Callable, x, feedback: Callable, outer: int = 5,
                    chain: int = 16, reps: int = 4) -> float:
    """Seconds a call of ``fn`` takes in a steady stream of dependent
    calls: ``chain`` calls a pass, each fed by ``feedback(prev_input,
    output)``, timed against one call a pass,

        t = (T(chain) - T(1)) / (chain - 1),

    each T the best of ``reps`` timings of ``outer`` passes (CUDA events on
    a card).  The difference leaves out what a pass costs once."""
    device = _device_of(x)
    _sync(device)
    feedback(x, fn(x))                      # warm up
    _sync(device)
    t1 = min(_chain_s(fn, x, feedback, 1, outer, device)
             for _ in range(reps))
    tk = min(_chain_s(fn, x, feedback, chain, outer, device)
             for _ in range(reps))
    return max((tk - t1) / (chain - 1), 1e-9)


def median_pair_time(l1: Callable, lc: Callable, x, chain: int,
                     iters: int = 9, strict: bool = False) -> float:
    """Median-of-pairs chained timing: seconds a call.

    ``l1`` and ``lc`` run 1 and ``chain`` dependent calls on ``x``; each
    iteration times both back to back (CUDA events on a card, the host
    clock to a synchronize elsewhere) and subtracts, so drift between
    separately timed phases cannot pass for kernel time.  The median is
    over all pairs, negative ones included.

    A non-positive median means jitter swamped the difference: the
    measurement retries with more pairs, and if the median stays
    non-positive falls back to the raw chained time ``t_chain / chain``,
    a positive upper bound.  ``strict=True`` raises instead.
    """
    if chain < 2:
        raise ValueError(f"chain must be >= 2, got {chain}")
    device = _device_of(x)
    pairs: list = []
    raw: list = []
    for _ in range(3):
        for _ in range(max(iters, 3)):
            _sync(device)
            t1 = _elapsed_s(lambda: l1(x), device)
            tc = _elapsed_s(lambda: lc(x), device)
            pairs.append((tc - t1) / (chain - 1))
            raw.append(tc / chain)
        med = float(np.median(pairs))
        if med > 0:
            return med
    if strict:
        raise RuntimeError(
            f"non-positive chained median over {len(pairs)} pairs; "
            "jitter swamped the measurement -- re-run")
    return float(np.median(raw))


def median_time_s(fn: Callable, iters: int, device: torch.device) -> float:
    """Median seconds of one ``fn()`` over ``iters`` calls after one
    warm-up call (CUDA events on a card)."""
    fn()
    _sync(device)
    return statistics.median(_elapsed_s(fn, device) for _ in range(iters))
