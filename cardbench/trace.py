"""Reading a ``torch.profiler`` Chrome trace of a slice of the window.

``attribute`` gives each device record (kernel, copy or fill) to the
``record_function`` scope its launch ran in on the host, by the
``correlation`` id that ties the two: a copy of the program's
``runtime/xprof.py`` arithmetic, kept here so that the yardstick does not
move with the program.  Unlike the original, a launch whose device record
is missing is counted (``Attribution.lost``) rather than raised: the
readers then see less device time, and the run says how many.

``busy`` is the union of the device records over an interval, ``gaps``
the idle stretches between them, each named by what the host was doing
at its middle.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SCOPE_CAT = "user_annotation"
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
LAUNCH_WORDS = ("Launch", "Memcpy", "Memset")
INF = float("inf")


@dataclasses.dataclass
class OpTime:
    """A device op's summed duration (s) and count under one scope."""

    name: str
    seconds: float
    count: int
    scope: str


@dataclasses.dataclass
class Attribution:
    ops: List[OpTime]
    lost: int            # launches in the root whose record is missing


def complete(events: List[dict], cats) -> List[dict]:
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in cats]


class Scopes:
    """The ``record_function`` scopes of one trace, by host thread, with
    the path of enclosing scope names of each."""

    def __init__(self, events: List[dict]):
        by_thread: Dict[Tuple, List[dict]] = {}
        for e in complete(events, (SCOPE_CAT,)):
            by_thread.setdefault((e["pid"], e["tid"]), []).append(e)
        self.threads = {}
        for key, evs in by_thread.items():
            evs.sort(key=lambda e: (float(e["ts"]), -float(e["dur"])))
            stack, rows = [], []
            for e in evs:
                ts, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
                # a child may end a rounding error after its parent
                while stack and rows[stack[-1]][1] < end - 1e-3:
                    stack.pop()
                parent = stack[-1] if stack else -1
                path = (rows[parent][2] + "/" if stack else "") + e["name"]
                stack.append(len(rows))
                rows.append((ts, end, path, parent))
            self.threads[key] = ([r[0] for r in rows], rows)

    def innermost(self, key, ts: float) -> str:
        """The path of the innermost scope open at host time ``ts`` on
        thread ``key``, or ''.  Scopes nest, so it is the last scope to
        start by ``ts`` or one of that scope's enclosing scopes."""
        starts, rows = self.threads.get(key, ([], []))
        i = bisect.bisect_right(starts, ts) - 1
        while i >= 0:
            t0, t1, path, parent = rows[i]
            if t0 <= ts <= t1:
                return path
            i = parent
        return ""


def under(path: str, root: str) -> Optional[str]:
    """``path`` relative to ``root`` ('' for the root itself), or None."""
    if path == root:
        return ""
    if path.startswith(root + "/"):
        return path[len(root) + 1:]
    return None


def attribute(events: List[dict], root: str) -> Attribution:
    """Device ops launched inside scope ``root``, each under the scope path
    (relative to ``root``) that was innermost at its launch."""
    scopes = Scopes(events)
    launches = {}
    for e in complete(events, LAUNCH_CATS):
        corr = e.get("args", {}).get("correlation")
        if corr is not None:
            launches[corr] = (e, under(scopes.innermost(
                (e["pid"], e["tid"]), float(e["ts"])), root))
    recorded = set()
    acc: Dict[Tuple[str, str], List[float]] = {}
    for e in complete(events, DEVICE_CATS):
        corr = e.get("args", {}).get("correlation")
        recorded.add(corr)
        if corr not in launches or launches[corr][1] is None:
            continue
        t = acc.setdefault((e["name"], launches[corr][1]), [0.0, 0])
        t[0] += float(e["dur"]) * 1e-6
        t[1] += 1
    lost = sum(1 for corr, (e, scope) in launches.items()
               if scope is not None and corr not in recorded
               and any(w in e["name"] for w in LAUNCH_WORDS))
    return Attribution([OpTime(n, t, c, s) for (n, s), (t, c) in acc.items()],
                       lost)


def scope_span(events: List[dict], name: str) -> Tuple[float, float, Tuple]:
    """(start, end) in trace microseconds of the one scope ``name``, and
    its host thread."""
    found = [e for e in complete(events, (SCOPE_CAT,)) if e["name"] == name]
    if len(found) != 1:
        raise RuntimeError(f"the trace holds {len(found)} scopes {name!r}")
    e = found[0]
    t0 = float(e["ts"])
    return t0, t0 + float(e["dur"]), (e["pid"], e["tid"])


def device_intervals(events: List[dict], t0: float = -INF,
                     t1: float = INF) -> List[Tuple[float, float]]:
    """The union of device records clipped to [t0, t1], sorted."""
    spans = sorted((max(t0, float(e["ts"])),
                    min(t1, float(e["ts"]) + float(e["dur"])))
                   for e in complete(events, DEVICE_CATS))
    merged: List[List[float]] = []
    for a, b in spans:
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def busy_us(intervals) -> float:
    return sum(b - a for a, b in intervals)


def gaps(events: List[dict], intervals, t0: float, t1: float, thread,
         n: int = 10) -> List[Tuple[str, float]]:
    """The ``n`` longest idle stretches of the device in [t0, t1], longest
    first, each named by the innermost host event of ``thread`` open at
    its middle ('' where none is); seconds."""
    edges = [t0] + [x for iv in intervals for x in iv] + [t1]
    idle = sorted(((b - a, a, b) for a, b in zip(edges[0::2], edges[1::2])
                   if b > a), reverse=True)[:n]
    host = [e for e in complete(events, HOST_CATS)
            if (e["pid"], e["tid"]) == thread]
    out = []
    for length, a, b in idle:
        mid = (a + b) / 2
        open_ = [e for e in host
                 if float(e["ts"]) <= mid <= float(e["ts"]) + float(e["dur"])]
        # host events nest: the innermost open one starts last
        name = max(open_, key=lambda e: float(e["ts"]))["name"] \
            if open_ else ""
        out.append((name, length * 1e-6))
    return out


def top_ops(events: List[dict], t0: float = -INF, t1: float = INF,
            n: int = 10) -> List[Tuple[str, float]]:
    """The ``n`` device ops with the most summed time in [t0, t1]."""
    tot: Dict[str, float] = {}
    for e in complete(events, DEVICE_CATS):
        a = max(t0, float(e["ts"]))
        b = min(t1, float(e["ts"]) + float(e["dur"]))
        if b > a:
            tot[e["name"]] = tot.get(e["name"], 0.0) + (b - a) * 1e-6
    return sorted(tot.items(), key=lambda kv: -kv[1])[:n]
