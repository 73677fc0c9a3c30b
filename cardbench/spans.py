"""What the readers of the program's own spans share: the host slice's
window and thread, the spans on that thread by their path below the
slice's scope, the card's idle stretches in the window, and device time
by the name of the scope a launch ran in.

The program opens ``engine.fill`` for each batch's fill of its staging
ring, with ``engine.ring_wait`` inside it where it waits on the ring's
event, ``engine.drain`` at the end of each ``stream`` call, the model's
layer scopes (``stem``, ``b{i}.c1`` ... ``pool``, ``fc``) beside them,
and ``im2col``, ``k4`` and ``join`` inside each block-sparse layer's
scope.  A program without a span gives no interval for it, and its
readers return None.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

from cardbench import trace
from cardbench.drivers.offline import SLICE

Interval = Tuple[float, float]


def window(ctx) -> Tuple[float, float, tuple]:
    """(start, end) of the host slice in trace microseconds, and its host
    thread."""
    return trace.scope_span(ctx.host_events, SLICE)


def spans(ctx, paths: Iterable[str], win=None) -> List[Interval]:
    """The spans on the host slice's thread whose path below the slice's
    scope is one of ``paths`` (``engine.fill``,
    ``engine.fill/engine.ring_wait``, ``b0.c1`` ...), sorted; ``win`` is
    ``window(ctx)`` where the caller has it."""
    _, _, thread = win or window(ctx)
    want = {SLICE + "/" + p for p in paths}
    _, rows = trace.Scopes(ctx.host_events).threads.get(thread, ([], []))
    return sorted((t0, t1) for t0, t1, path, _ in rows if path in want)


def idle(ctx, win=None) -> List[Interval]:
    """The stretches of the host slice in which the card ran nothing."""
    t0, t1, _ = win or window(ctx)
    edges = [t0] + [x for iv in trace.device_intervals(
        ctx.host_events, t0, t1) for x in iv] + [t1]
    return [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]


def overlap_us(a: List[Interval], b: List[Interval]) -> float:
    """Length of the intersection of two sorted lists of intervals, each
    without overlaps of its own."""
    i = j = 0
    out = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def idle_share_in(ctx, paths: Iterable[str]) -> Optional[float]:
    """Share of the host slice's window in which the card ran nothing
    while the host was inside one of the spans ``paths``, percent; None
    where there is no such span."""
    win = window(ctx)
    host = spans(ctx, paths, win)
    if not host:
        return None
    return 100.0 * overlap_us(idle(ctx, win), host) / (win[1] - win[0])


def device_ms_per_batch_under(ctx, name: str) -> Optional[float]:
    """Device milliseconds a batch of the host slice launched inside a
    scope named ``name`` nested in another (``b3.c1/im2col``), or None."""
    s = sum(op.seconds for op in ctx.attribution.ops
            if name in op.scope.split("/")[1:])
    if s <= 0:
        return None
    return 1e3 * s / ctx.host_batches
