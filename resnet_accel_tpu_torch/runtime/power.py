"""Power and energy of a measured region: live from ``nvidia-smi``, or
modeled.

Counterpart of ``resnet_accel_tpu/runtime/power.py``, which keeps the
reference's report (average and peak watts, energy, GOPS/W) with power
modeled from a published TDP because its chip exposes no telemetry, and
asks for measured watts wherever live telemetry exists.  On a card it
does: ``nvidia-smi`` (shipped with the driver) reads the board's power
draw, its power limit and the SM clock.  ``PowerSampler`` samples
``power.draw.instant`` (``power.draw`` where the driver lacks that field)
and ``clocks.sm`` over a region and gives a ``PowerProfile`` with
``modeled=False``.  ``estimate_power`` keeps the model, with the TDP and
idle watts given by its caller (``probe_live_telemetry`` reads both on a
card: the power limit and a reading taken before any load).
"""

from __future__ import annotations

import dataclasses
import glob
import os
import shutil
import statistics
import subprocess
import threading
import time
from typing import List, Optional

import torch

#: The power fields ``nvidia-smi`` may offer, preferred first: the
#: instantaneous draw, then the driver's one-second average.
POWER_FIELDS = ("power.draw.instant", "power.draw")


@dataclasses.dataclass
class PowerProfile:
    """Power and energy of one measured region; ``modeled`` marks an
    estimate."""

    name: str
    duration_s: float
    avg_w: float
    peak_w: float
    total_ops: int = 0
    modeled: bool = True

    @property
    def energy_j(self) -> float:
        return self.avg_w * self.duration_s

    @property
    def energy_mj(self) -> float:
        return self.energy_j * 1e3

    @property
    def gops_per_w(self) -> float:
        if not self.duration_s or not self.avg_w:
            return 0.0
        return (self.total_ops / self.duration_s / 1e9) / self.avg_w

    def report(self) -> str:
        tag = " (modeled)" if self.modeled else ""
        return (f"[{self.name}] {self.avg_w:.1f} W avg / "
                f"{self.peak_w:.1f} W peak{tag} | "
                f"{self.energy_mj:.1f} mJ | "
                f"{self.gops_per_w:.1f} GOPS/W")


def _smi(*fields: str, index: int = 0) -> Optional[List[str]]:
    """One ``nvidia-smi`` reading of ``fields`` on card ``index`` (values
    without units), or None where it is absent or refuses a field."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    proc = subprocess.run(
        [exe, f"--query-gpu={','.join(fields)}", "--format=csv,noheader,"
         "nounits", "-i", str(index)], capture_output=True, text=True,
        timeout=60)
    vals = [v.strip() for v in proc.stdout.strip().split(",")]
    if proc.returncode != 0 or len(vals) != len(fields) or any(
            v.startswith("[") for v in vals):   # "[Not Supported]", ...
        return None
    return vals


def power_field(index: int = 0) -> Optional[str]:
    """The first of ``POWER_FIELDS`` that ``nvidia-smi`` reads on card
    ``index``, or None."""
    return next((f for f in POWER_FIELDS if _smi(f, index=index)), None)


def probe_live_telemetry(index: int = 0) -> dict:
    """Every telemetry source a card's host could expose, found or not:
    {source: status}.

    - ``nvidia_smi``: on ``PATH``; found, its power field, the card's power
      limit and one power reading, taken now (call this before any load
      for the idle watts);
    - ``hwmon_rails``: kernel hwmon rails whose name mentions a GPU;
    - ``torch_cuda_memory_stats``: the caching allocator's counters (memory,
      not power), where a card is present.
    """
    status = {}
    field = power_field(index)
    vals = _smi(field, "power.limit", index=index) if field else None
    status["nvidia_smi"] = "none" if vals is None else {
        "path": shutil.which("nvidia-smi"), "field": field,
        "power_limit_w": float(vals[1]), "idle_w": float(vals[0])}
    rails = []
    for p in glob.glob("/sys/class/hwmon/hwmon*/name"):
        try:  # a device may vanish or be unreadable between glob and open
            with open(p) as f:
                name = f.read().strip().lower()
        except OSError:
            continue
        if "gpu" in name or "nvidia" in name:
            rails.append(os.path.dirname(p))
    status["hwmon_rails"] = rails or "none"
    status["torch_cuda_memory_stats"] = (
        "available" if torch.cuda.is_available() else "none")
    return status


def estimate_power(name: str, duration_s: float, total_ops: int,
                   utilization: float, tdp_w: float,
                   idle_w: float) -> PowerProfile:
    """Model the card's power as idle + utilization * (TDP - idle).

    ``utilization`` is the measured fraction of the int8 peak
    (``runtime.perf.PerfMetrics.utilization``).
    """
    u = min(max(utilization, 0.0), 1.0)
    avg = idle_w + u * (tdp_w - idle_w)
    return PowerProfile(name=name, duration_s=duration_s, avg_w=avg,
                        peak_w=tdp_w if u > 0 else idle_w,
                        total_ops=total_ops, modeled=True)


class PowerSampler:
    """Live power and SM clock of card ``index`` over a region:

        with PowerSampler() as ps:
            ...work...
        ps.profile("forward", total_ops)

    A thread reads the power field and ``clocks.sm`` through
    ``nvidia-smi`` again and again (one process at a time, each waited
    for) until the region ends.  Raises where ``nvidia-smi`` reads no
    power field."""

    def __init__(self, index: int = 0):
        self.index = index
        self.field = power_field(index)
        if self.field is None:
            raise RuntimeError("nvidia-smi is absent or reads no power "
                               f"field ({', '.join(POWER_FIELDS)})")
        self._samples: List[tuple] = []    # (host time, W, SM MHz)
        self.watts: List[float] = []
        self.sm_mhz: List[float] = []
        self.duration_s = 0.0
        self._stop = threading.Event()
        self._reader = threading.Thread(target=self._read, daemon=True)

    def _read(self) -> None:
        while not self._stop.is_set():
            t = time.perf_counter()
            vals = _smi(self.field, "clocks.sm", index=self.index)
            if vals is not None:
                self._samples.append((t, float(vals[0]), float(vals[1])))

    def __enter__(self) -> "PowerSampler":
        self._t0 = time.perf_counter()
        self._reader.start()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter()
        self.duration_s = t1 - self._t0
        self._stop.set()
        self._reader.join(timeout=120)
        # only the readings begun inside the region
        inside = [s for s in self._samples if s[0] < t1]
        self.watts = [s[1] for s in inside]
        self.sm_mhz = [s[2] for s in inside]

    def profile(self, name: str, total_ops: int = 0) -> PowerProfile:
        """The region's ``PowerProfile`` from the samples (``modeled``
        False)."""
        if not self.watts:
            raise RuntimeError(f"no {self.field} sample over the region "
                               f"({self.duration_s:.3f} s)")
        return PowerProfile(name=name, duration_s=self.duration_s,
                            avg_w=statistics.fmean(self.watts),
                            peak_w=max(self.watts), total_ops=total_ops,
                            modeled=False)

    @property
    def avg_sm_mhz(self) -> float:
        return statistics.fmean(self.sm_mhz) if self.sm_mhz else 0.0
