"""What a per-layer metric's reader reads: the two traced slices of the
window, the device work by scope, and the layers' operations and bytes.

A reader is ``cardbench/metrics/<name>.py`` (dots and dashes of the
metric's name as underscores) with ``read(ctx) -> float or None``; None
means it found nothing to read, and the run leaves the metric out.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from cardbench import peaks, trace


@dataclasses.dataclass
class TraceContext:
    batches: int                     # batches of the device slice
    window_s: float                  # the device slice, host clock
    device_events: List[dict]        # the device slice's records
    intervals: List[Tuple[float, float]]   # device busy in that slice
    host_batches: int                # batches of the host slice
    host_events: List[dict]          # the host slice's records
    attribution: trace.Attribution   # its device ops under the scopes
    layers: list                     # ``work.<kind>.Layer`` of one batch
    bound_s: object                  # the work module's ``bound_s``
    untraced_batches: int = 0        # the window's calls outside the slices
    untraced_s: float = 0.0          # their host-clock seconds

    @property
    def busy_s(self) -> float:
        return trace.busy_us(self.intervals) * 1e-6

    def scope_seconds(self) -> Dict[str, float]:
        """Device seconds of the host slice by the outermost scope."""
        out: Dict[str, float] = {}
        for op in self.attribution.ops:
            key = op.scope.split("/")[0]
            out[key] = out.get(key, 0.0) + op.seconds
        return out


def roofline_share(ctx: TraceContext, kind: str) -> Optional[float]:
    """The summed bounds of the layers of ``kind`` over the host slice's
    batches, as a percentage of the device time under their scopes."""
    layers = [l for l in ctx.layers if l.kind == kind]
    if not layers:
        return None
    by_scope = ctx.scope_seconds()
    spent = sum(by_scope.get(l.scope, 0.0) for l in layers)
    if spent <= 0:
        return None
    bound = ctx.host_batches * sum(
        ctx.bound_s(l, peaks.INT8_OPS_PER_S, peaks.HBM_BYTES_PER_S)
        for l in layers)
    return 100.0 * bound / spent
