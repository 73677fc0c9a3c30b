"""One run of one cell: set-up, the measured window, the check, the metrics.

Everything is found by name.  The cell's configuration file names its
``kind``, which selects ``models/<kind>.py`` (the benchmark's raw inputs,
the program's build, engine and state), ``reference/<kind>.py`` (the plain
reference and its checks of the program's state) and ``work/<kind>.py``
(operations and bytes); the traffic file names its ``driver``,
``drivers/<driver>.py``, which makes the served inputs, runs the window,
counts and checks what it served and gives the end-to-end metrics; each
per-layer metric is read by ``metrics/<name>.py``.  The harness only
collects them, so adding a configuration, a traffic mix or a metric adds
files and ``BENCHMARK.json`` entries and edits none.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import os
import sys
import time
from typing import Dict, List, Tuple

import torch

from cardbench import trace
from cardbench.context import TraceContext

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_bench(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def resolve(bench: dict, workload: str, root: str = ROOT
            ) -> Tuple[dict, dict, dict]:
    """The cell named ``workload``, its configuration and traffic mix."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return cell, config, traffic


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports the end-to-end ``metric``: every cell, or
    those its ``workloads`` lists."""
    return "workloads" not in metric or cell in metric["workloads"]


def per_layer_metrics(bench: dict, cell: str) -> List[dict]:
    """The per-layer metrics whose ``workloads`` list this cell; every
    per-layer entry carries that list."""
    return [m for m in bench["per_layer"] if cell in m["workloads"]]


def reader(name: str):
    return importlib.import_module(
        "cardbench.metrics." + name.replace(".", "_").replace("-", "_"))


@dataclasses.dataclass
class Outcome:
    result: dict
    checks: List[Tuple[str, float, float]]


def run_cell(bench: dict, cell: dict, config: dict, traffic: dict,
             seed: int, seconds: float, traced: bool, device,
             t_start: float) -> Outcome:
    kind = config["kind"]
    model = importlib.import_module(f"cardbench.models.{kind}")
    ref_mod = importlib.import_module(f"cardbench.reference.{kind}")
    work = importlib.import_module(f"cardbench.work.{kind}")
    driver = importlib.import_module(f"cardbench.drivers.{traffic['driver']}")
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    # ---- set-up: the raw inputs, the program's model, the library -------
    t = time.perf_counter()
    inputs = model.inputs(config, seed, dev)
    program = model.build(config, inputs)
    eng = model.engine(program, dev)
    lib = driver.library(model, config, traffic, seed, program, dev)
    t_built = time.perf_counter()
    driver.warmup(eng, lib, traffic)
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s: imports and device {t - t_start:.3f}, "
        f"inputs, build and library {t_built - t:.3f}, warm-up "
        f"{time.perf_counter() - t_built:.3f}")

    # ---- the window --------------------------------------------------------
    win = driver.window(eng, lib, traffic, seconds, traced, dev)
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    state = model.state(program)
    del eng, program, lib
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # ---- the check: what the window served against the reference ---------
    t = time.perf_counter()
    ref = ref_mod.Reference(config, inputs)
    checks, failed = driver.check(win, ref, model, config, traffic, seed,
                                  dev)
    checks += ref.state_checks(state)
    log(f"check {time.perf_counter() - t:.3f} s")

    # ---- the metrics -------------------------------------------------------
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                "count": 1, "memory_peak_bytes": peak}
    result: Dict[str, object] = {}
    metrics: Dict[str, dict] = {}
    if not traced:
        values = dict(driver.end_to_end(win, traffic), setup_s=setup_s)
        for m in bench["end_to_end"]:
            if reports(m, cell["name"]) and m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        ctx, result["breakdown"] = traced_context(
            win, driver.SLICE, work.step_layers(config, traffic, ref),
            work.bound_s)
        for m in per_layer_metrics(bench, cell["name"]):
            v = reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev_info["busy_s"] = ctx.busy_s
        dev_info["window_s"] = ctx.window_s
    correct = all(v <= lim for _, v, lim in checks)
    out = {"correct": correct, "attempted": driver.served(win, traffic),
           "failed": failed, "metrics": metrics, "device": dev_info}
    out.update(result)
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in checks}
    return Outcome(out, checks)


def traced_context(win, scope: str, layers, bound_s
                   ) -> Tuple[TraceContext, dict]:
    """The readers' view of a traced window, with what it saw logged, and
    the breakdown: the device ops of the device slice that took most time,
    and the host slice's longest idle gaps by what the host was doing."""
    t0, t1, thread = trace.scope_span(win.host_events, scope)
    att = trace.attribute(win.host_events, scope)
    ctx = TraceContext(win.device_batches, win.device_s, win.device_events,
                       trace.device_intervals(win.device_events),
                       win.host_batches, win.host_events, att, layers,
                       bound_s, win.untraced_batches, win.untraced_s)
    host_iv = trace.device_intervals(win.host_events, t0, t1)
    host_busy = trace.busy_us(host_iv) * 1e-6
    log(f"trace: device slice {ctx.window_s:.6f} s, busy {ctx.busy_s:.6f} "
        f"s; host slice {(t1 - t0) * 1e-6:.6f} s, busy {host_busy:.6f} s, "
        f"{len(win.host_events)} records, {att.lost} launches without a "
        f"device record; {ctx.batches} and {ctx.host_batches} batches")
    log(f"untraced calls: {win.untraced_batches} batches in "
        f"{win.untraced_s:.6f} s")
    kinds = {l.scope: l.kind for l in layers}
    by_kind: Dict[str, float] = {}
    for scope, sec in ctx.scope_seconds().items():
        k = kinds.get(scope, scope or "unscoped")
        by_kind[k] = by_kind.get(k, 0.0) + sec
    log("device s by layer kind: " + ", ".join(
        f"{k} {v:.6f}" for k, v in sorted(by_kind.items(),
                                         key=lambda kv: -kv[1])))
    breakdown = {
        "device_ops": [list(x) for x in trace.top_ops(win.device_events)],
        "idle_gaps": [list(x) for x in trace.gaps(
            win.host_events, host_iv, t0, t1, thread)]}
    return ctx, breakdown
