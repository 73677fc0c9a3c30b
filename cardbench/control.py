"""The readings a cell's ``logit_gap`` limit is set from.

    python3 -m cardbench.control --workload W --seeds 1,2,... \
        --control-seeds 7,8,9 --seconds S [--faults]

On the card, in one process: for each of ``--seeds`` a sound run of the
cell (``harness.run_cell``, the window ``--seconds`` long) and its
compared numbers (the lower reading); for each of ``--control-seeds`` the
control, the reference computed in INT4 (one precision below the
configuration's INT8) in the program's place, judged against the INT8
reference over the library the window serves (the upper reading); with
``--faults``, each planted fault of the program on the control seeds.  One
JSON line a reading.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import sys
import time

import numpy as np

from cardbench import compare, harness

DEVICE = "cuda:0"


@contextlib.contextmanager
def planted(fault: str, batch: int):
    """The program's forward with ``fault``: ``altered`` (one image's
    logits of each batch rotated by one class), ``half`` (the second half
    of each batch left out: zeros), ``stale`` (every batch answered with
    the first batch's logits)."""
    from resnet_accel_tpu_torch.models.resnet18 import ResNet18Int8Module
    orig = ResNet18Int8Module.forward
    first = []

    def forward(self, x):
        out = orig(self, x)
        if fault == "altered":
            out[0] = out[0].roll(1)
        elif fault == "half":
            out[batch // 2:] = 0
        elif fault == "stale":
            if not first:
                first.append(out.clone())
            out = first[0].clone()
        return out

    ResNet18Int8Module.forward = forward
    try:
        yield
    finally:
        ResNet18Int8Module.forward = orig


def control_gaps(config, traffic, seed: int, device, bits: int = 4):
    """Widest and least row gap of the reference at ``bits`` against the
    INT8 reference over the library's images."""
    kind = config["kind"]
    model = importlib.import_module(f"cardbench.models.{kind}")
    ref_mod = importlib.import_module(f"cardbench.reference.{kind}")
    driver = importlib.import_module(f"cardbench.drivers.{traffic['driver']}")
    inputs = model.inputs(config, seed, device)
    ref8 = ref_mod.Reference(config, inputs)
    low = ref_mod.Reference(config, inputs, bits=bits)
    gaps = []
    for k in range(traffic["library_images"] // traffic["batch"]):
        x = driver.library_fp32(model, config, traffic, seed, k, device)
        gaps.append(compare.row_gaps(low.logits(x).numpy(),
                                     ref8.logits(x).numpy()))
    g = np.concatenate(gaps)
    return float(g.max()), float(g.min())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cardbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args(argv)
    bench = harness.load_bench()
    cell, config, traffic = harness.resolve(bench, args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]

    def emit(**kw):
        print(json.dumps(dict(workload=args.workload, **kw)), flush=True)

    def sound(seed, what):
        t = time.perf_counter()
        out = harness.run_cell(bench, cell, config, traffic, seed,
                               args.seconds, False, DEVICE, t)
        emit(reading=what, seed=seed, correct=out.result["correct"],
             checks={n: v for n, v, _ in out.checks},
             img_per_s=out.result["metrics"]["img_per_s"]["value"],
             seconds=time.perf_counter() - t)

    for seed in seeds:
        sound(seed, "program")
    for seed in cseeds:
        t = time.perf_counter()
        widest, least = control_gaps(config, traffic, seed, DEVICE)
        emit(reading="control_int4", seed=seed, logit_gap=widest,
             least_row_gap=least, seconds=time.perf_counter() - t)
    if args.faults:
        for fault in ("altered", "half", "stale"):
            for seed in cseeds:
                with planted(fault, traffic["batch"]):
                    sound(seed, f"fault_{fault}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
