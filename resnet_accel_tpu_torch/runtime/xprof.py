"""Measured per-layer device time from a ``torch.profiler`` trace.

Counterpart of ``resnet_accel_tpu/runtime/xprof.py``, which reads scopes
from the compiled HLO and times from the TPU's xplane.  Here the model
marks its layers with ``torch.profiler.record_function`` scopes
(``models/resnet18.py``), and one call, in a scope of its own
(``CALL_SCOPE``), is captured under ``torch.profiler.profile`` (CPU and
CUDA activities) and exported as a Chrome trace.  Each device kernel (and
copy or fill) in the trace names, by its ``correlation`` id, the host call
that launched it (``cudaLaunchKernel``, ``cuLaunchKernel`` ...); that
call lies on the host's timeline inside the scopes that were open when it
ran, and the innermost of them, with its enclosing scopes, is the
kernel's scope:

    fn, args --torch.profiler--> Chrome trace events
             --attribute--> per-op device time, each with its scope path
             --by_scope--> scope -> seconds

A kernel of the call whose launch is not in the trace, or that the call
launched outside every layer scope, reaches no scope and counts as
``<unattributed>``; a launch of the call whose kernel is missing from the
trace makes the attribution fail.  On the CPU there is no device time:
each scope gets the host time spent in it and not in a scope inside it.
``attribute`` is a pure function of the trace's events, kept apart from
the capture so that it is tested without a card.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
from typing import Callable, Dict, List, Optional, Tuple

import torch

#: Chrome-trace categories of device work, and of the host calls that
#: launch it.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SCOPE_CAT = "user_annotation"
UNATTRIBUTED = "<unattributed>"
#: The scope ``capture`` runs the traced call in.
CALL_SCOPE = "xprof.call"
#: Host calls that put work on the device (and so have a device record).
LAUNCH_WORDS = ("Launch", "Memcpy", "Memset")
#: Short spins of the card (of ``LEAD_CYCLES`` clock cycles each, about
#: 10 us) launched in the trace before the traced call.  On an H100
#: (torch 2.11, CUDA 12.8) a trace was seen to lack the first device
#: records of its session, more of them the longer the process had run
#: since its first trace: these records go first, and the call's come
#: after them.
LEAD_KERNELS = 512
LEAD_CYCLES = 20_000


@dataclasses.dataclass
class OpTime:
    """One executed op (a device kernel; on the CPU, a scope's own host
    time): its summed duration over its occurrences under ``scope``."""

    instr: str
    duration_s: float
    count: int
    scope: str = ""


def _complete(events: List[dict], cats) -> List[dict]:
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in cats]


class _Scopes:
    """The ``record_function`` scopes of one trace, by host thread, with
    the path of enclosing scope names of each."""

    def __init__(self, events: List[dict]):
        by_thread: Dict[Tuple, List[dict]] = {}
        for e in _complete(events, (SCOPE_CAT,)):
            by_thread.setdefault((e["pid"], e["tid"]), []).append(e)
        self.threads = {}
        for key, evs in by_thread.items():
            # outer before inner where two start together
            evs.sort(key=lambda e: (float(e["ts"]), -float(e["dur"])))
            stack, rows = [], []
            for e in evs:
                ts, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
                # (a child may end a rounding error, under a ns, after
                # its parent)
                while stack and stack[-1][1] < end - 1e-3:
                    stack.pop()
                path = "/".join([s[2] for s in stack] + [e["name"]])
                stack.append((ts, end, path))
                rows.append((ts, end, path))
            self.threads[key] = ([r[0] for r in rows], rows)

    def innermost(self, key, ts: float) -> str:
        """The path of the innermost scope open at host time ``ts`` on
        thread ``key``, or ''."""
        starts, rows = self.threads.get(key, ([], []))
        i = bisect.bisect_right(starts, ts) - 1
        best = ""
        # scopes nest, so the innermost open one starts last
        while i >= 0:
            t0, t1, path = rows[i]
            if t0 <= ts <= t1:
                best = path
                break
            i -= 1
        return best

    def self_times(self) -> Dict[str, float]:
        """Each scope path's host time outside its inner scopes, seconds."""
        out: Dict[str, float] = {}
        for _, rows in self.threads.values():
            for t0, t1, path in rows:
                out[path] = out.get(path, 0.0) + (t1 - t0) * 1e-6
                parent = path.rpartition("/")[0]
                if parent:
                    out[parent] = out.get(parent, 0.0) - (t1 - t0) * 1e-6
        return out


def _under(path: str, root: str) -> Optional[str]:
    """``path`` relative to scope ``root`` ('' for ``root`` itself), or
    None where it is not inside ``root``; every path with no ``root``."""
    if not root:
        return path
    if path == root:
        return ""
    if path.startswith(root + "/"):
        return path[len(root) + 1:]
    return None


def attribute(events: List[dict], device: bool,
              root: str = "") -> List[OpTime]:
    """Per-op times of one trace (its ``traceEvents``), each with its scope.

    ``device``: the device kernels, copies and fills, each under the scope
    its launch ran in ('' where there is none or the launch is not in the
    trace); else the scopes' own host time (``instr`` is the scope).
    ``root``: keep only what was launched (or ran) inside that scope,
    with scope paths relative to it; a launch there whose device record is
    missing raises.
    """
    scopes = _Scopes(events)
    if not device:
        ops = []
        for path, t in scopes.self_times().items():
            rel = _under(path, root)
            if rel:
                ops.append(OpTime(instr=rel, duration_s=t, count=1,
                                  scope=rel))
        return ops
    work = _complete(events, DEVICE_CATS)
    if not work:
        raise RuntimeError("the trace holds no device kernel: the profiler "
                           "recorded no CUDA activity")
    launches = {}
    for e in _complete(events, LAUNCH_CATS):
        corr = e.get("args", {}).get("correlation")
        if corr is not None:
            launches[corr] = (e, _under(scopes.innermost(
                (e["pid"], e["tid"]), float(e["ts"])), root))
    recorded = set()
    acc: Dict[Tuple[str, str], List[float]] = {}
    for e in work:
        corr = e.get("args", {}).get("correlation")
        recorded.add(corr)
        scope = launches[corr][1] if corr in launches else ""
        if scope is None:               # launched outside ``root``
            continue
        t = acc.setdefault((e["name"], scope), [0.0, 0])
        t[0] += float(e["dur"]) * 1e-6
        t[1] += 1
    lost = [e["name"] for corr, (e, scope) in launches.items()
            if scope is not None and corr not in recorded
            and any(w in e["name"] for w in LAUNCH_WORDS)]
    if lost:
        raise RuntimeError(
            f"{len(lost)} launches ({', '.join(sorted(set(lost)))}) have no "
            f"device record in the trace: the profiler lost their work")
    return [OpTime(instr=name, duration_s=t, count=c, scope=scope)
            for (name, scope), (t, c) in acc.items()]


def by_scope(ops: List[OpTime], depth: int = 1) -> Dict[str, float]:
    """Seconds by the first ``depth`` components of each op's scope
    ('' -> ``<unattributed>``)."""
    out: Dict[str, float] = {}
    for o in ops:
        key = ("/".join(o.scope.split("/")[:depth]) if o.scope
               else UNATTRIBUTED)
        out[key] = out.get(key, 0.0) + o.duration_s
    return out


def capture(fn: Callable, *args, logdir: Optional[str] = None
            ) -> Tuple[List[dict], bool]:
    """Warm up ``fn(*args)`` once, then trace one call, in the scope
    ``CALL_SCOPE`` and after ``LEAD_KERNELS`` spins of the card, under
    ``torch.profiler`` (CUDA activity too where an argument is on a card);
    returns the trace's events and whether they hold device time.  The
    Chrome trace is kept in ``logdir`` when one is given."""
    from torch.profiler import ProfilerActivity, profile, record_function
    device = next((a.device for a in args if isinstance(a, torch.Tensor)),
                  torch.device("cpu"))
    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with torch.inference_mode():
        fn(*args)
        if cuda:
            torch.cuda.synchronize(device)
        with profile(activities=acts) as prof:
            if cuda:
                for _ in range(LEAD_KERNELS):
                    torch.cuda._sleep(LEAD_CYCLES)
            with record_function(CALL_SCOPE):
                fn(*args)
            if cuda:
                torch.cuda.synchronize(device)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(logdir or tmp, "xprof_trace.json")
        if logdir:
            os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return events, cuda


def profile_layers(fn: Callable, *args, logdir: Optional[str] = None,
                   depth: int = 1) -> Tuple[Dict[str, float], List[OpTime]]:
    """Measured time of each scope in one call of ``fn(*args)``: device
    time on a card, host time on the CPU.  Returns (scope -> seconds,
    per-op detail)."""
    events, cuda = capture(fn, *args, logdir=logdir)
    ops = attribute(events, device=cuda, root=CALL_SCOPE)
    return by_scope(ops, depth=depth), ops


def layer_table(scope_s: Dict[str, float],
                bounds: Optional[Dict[str, float]] = None) -> str:
    """Printable measured per-layer table, largest first; with ``bounds``
    (scope -> seconds, e.g. each row's roofline time from
    ``profile_resnet18``) each row's bound beside it."""
    total = sum(scope_s.values()) or 1.0
    head = f"{'scope':24s} {'us':>10s} {'%':>6s}"
    lines = [head + (f" {'bound us':>10s}" if bounds is not None else "")]
    for k, v in sorted(scope_s.items(), key=lambda kv: -kv[1]):
        row = f"{k:24s} {v * 1e6:10.1f} {100 * v / total:6.2f}"
        if bounds is not None:
            b = bounds.get(k)
            row += f" {b * 1e6:10.1f}" if b is not None else f" {'-':>10s}"
        lines.append(row)
    tail = f"{'TOTAL':24s} {total * 1e6:10.1f} {100.0:6.2f}"
    if bounds is not None:
        tail += f" {sum(bounds.values()) * 1e6:10.1f}"
    lines.append(tail)
    return "\n".join(lines)
