"""A closed loop of offline ``stream`` calls over int8 images in host memory.

Before the window the library is made: ``library_images`` fp32 images
drawn from the seed, quantized to int8 by the program with its input scale
and held in host memory as batches of ``batch``.  The window then calls
``engine.stream(library, batches_per_call)`` back to back until
``seconds`` have passed; each call feeds the library's batches in turn
through the engine's staging ring and ends with the logits on the host.
The first ``WARMUP_CALLS`` calls, before the window, are set-up.

With a trace, after ``TRACE_SKIP_CALLS`` calls of the window, two slices
run under ``torch.profiler``: the device slice, ``DEVICE_SLICE_CALLS``
calls, records device activity alone, so that the profiler's cost on the
host moves the card's busy and idle time little, and is long enough that
the host's pace averages out; the host slice, ``HOST_SLICE_CALLS`` calls,
records the host's operators and the program's scopes beside it, for the
device time by layer and the idle gaps by what the host was doing.  The
window runs on until both are done.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from cardbench import compare

SLICE = "cardbench.slice"
WARMUP_CALLS = 1
TRACE_SKIP_CALLS = 2
DEVICE_SLICE_CALLS = 6
HOST_SLICE_CALLS = 2
#: Spins of the card before each traced slice: a trace was seen to lack its
#: session's first device records (the program's ``runtime/xprof.py``), so
#: these go first and the slice's records after them.  The device slice
#: drops them by name.
LEAD_KERNELS = 512
LEAD_CYCLES = 20_000
LEAD_NAME = "spin_kernel"


class Library:
    """The int8 batches, handed out in turn by ``next()`` as the engine's
    ``stream`` takes them; ``handed`` records which, in order."""

    has_labels = False

    def __init__(self, batches: List[np.ndarray]):
        self.batches = batches
        self.handed: List[int] = []
        self._i = 0

    def next(self) -> Tuple[np.ndarray, None]:
        k = self._i
        self._i = (k + 1) % len(self.batches)
        self.handed.append(k)
        return self.batches[k], None


@dataclasses.dataclass
class Window:
    calls: List[Tuple[List[int], np.ndarray]]   # (batches handed, logits)
    seconds: float
    call_seconds: List[float]
    # with a trace: each slice's records and batches, the device slice's
    # host-clock length, and the batches and seconds of the untraced calls
    device_events: Optional[list] = None
    device_batches: int = 0
    device_s: float = 0.0
    host_events: Optional[list] = None
    host_batches: int = 0
    untraced_batches: int = 0
    untraced_s: float = 0.0


def served(win: Window, traffic) -> int:
    return sum(len(idx) for idx, _ in win.calls) * traffic["batch"]


def end_to_end(win: Window, traffic) -> Dict[str, float]:
    """``img_per_s``: images whose logits reached the host, over the
    host-clock seconds of the whole window."""
    return {"img_per_s": served(win, traffic) / win.seconds}


def library(model_mod, config, traffic, seed: int, program, device
            ) -> Library:
    b = traffic["batch"]
    n = traffic["library_images"] // b
    return Library([model_mod.quantize(program, model_mod.images(
        config, seed, f"library/{k}", b, device)).cpu().numpy()
        for k in range(n)])


def library_fp32(model_mod, config, traffic, seed: int, k: int, device):
    """Batch ``k`` of the library in fp32, as ``library`` drew it."""
    return model_mod.images(config, seed, f"library/{k}", traffic["batch"],
                            device)


def check(win: Window, ref, model_mod, config, traffic, seed: int, device
          ) -> Tuple[List[Tuple[str, float, float]], int]:
    """Every served row against the reference's logits of the same library
    image: the widest row gap (``compare.row_gaps``) against the
    configuration's ``logit_gap``, and the rows a call left out.  Returns
    the checks and the number of failed answers."""
    batch = traffic["batch"]
    want = [ref.logits(library_fp32(model_mod, config, traffic, seed, k,
                                    device)).numpy()
            for k in range(traffic["library_images"] // batch)]
    limit = config["check"]["logit_gap"]
    worst, over, missing = 0.0, 0, 0
    for idx, logits in win.calls:
        for j, k in enumerate(idx):
            part = logits[j * batch:(j + 1) * batch]
            missing += batch - part.shape[0]
            if np.array_equal(part, want[k][:part.shape[0]]):
                continue
            gaps = compare.row_gaps(part, want[k][:part.shape[0]])
            worst = max(worst, float(gaps.max()))
            over += int((gaps > limit).sum())
    return ([("logit_gap", worst, limit), ("missing_answers", missing, 0)],
            over + missing)


def _call(engine, lib: Library, n: int, calls, times) -> None:
    t = time.perf_counter()
    start = len(lib.handed)
    res = engine.stream(lib, n)
    calls.append((lib.handed[start:], res.logits))
    times.append(time.perf_counter() - t)


def warmup(engine, lib: Library, traffic) -> None:
    for _ in range(WARMUP_CALLS):
        _call(engine, lib, traffic["batches_per_call"], [], [])
    lib.handed.clear()


def _slice(engine, lib: Library, n: int, calls, times, device,
           host: bool) -> Tuple[list, float]:
    """The device slice's calls, or with ``host`` the host slice's, under
    the profiler: the trace's records and the calls' host-clock
    seconds."""
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CUDA] if cuda else []
    if host or not cuda:
        acts.append(ProfilerActivity.CPU)
    prof = profile(activities=acts)
    prof.start()
    if cuda:
        for _ in range(LEAD_KERNELS):
            torch.cuda._sleep(LEAD_CYCLES)
        torch.cuda.synchronize(device)
    t = time.perf_counter()
    with record_function(SLICE):
        for _ in range(HOST_SLICE_CALLS if host else DEVICE_SLICE_CALLS):
            _call(engine, lib, n, calls, times)
    seconds = time.perf_counter() - t
    prof.stop()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return events, seconds


def window(engine, lib: Library, traffic, seconds: float, trace: bool,
           device) -> Window:
    n = traffic["batches_per_call"]
    calls: List[Tuple[List[int], np.ndarray]] = []
    times: List[float] = []
    win = Window(calls, 0.0, times)
    t0 = time.perf_counter()
    while True:
        if trace and len(calls) == TRACE_SKIP_CALLS:
            events, win.device_s = _slice(engine, lib, n, calls, times,
                                          device, host=False)
            win.device_events = [e for e in events
                                 if LEAD_NAME not in e.get("name", "")]
            leads = len(events) - len(win.device_events)
            win.host_events, _ = _slice(engine, lib, n, calls, times,
                                        device, host=True)
            win.device_batches = n * DEVICE_SLICE_CALLS
            win.host_batches = n * HOST_SLICE_CALLS
        else:
            _call(engine, lib, n, calls, times)
        if time.perf_counter() - t0 >= seconds and (
                not trace or win.host_events is not None):
            break
    win.seconds = time.perf_counter() - t0
    untraced = [t for i, t in enumerate(times)
                if not (trace and TRACE_SKIP_CALLS <= i < TRACE_SKIP_CALLS
                        + DEVICE_SLICE_CALLS + HOST_SLICE_CALLS)]
    win.untraced_batches, win.untraced_s = n * len(untraced), sum(untraced)
    print(f"window {win.seconds:.3f} s: {len(calls)} calls, "
          f"{served(win, traffic)} images; calls "
          f"{' '.join(f'{t:.4f}' for t in times)} s"
          + (f"; device slice {win.device_s:.6f} s, {leads} lead records "
             f"dropped" if trace else ""), file=sys.stderr, flush=True)
    return win
