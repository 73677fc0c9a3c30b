"""cardbench: the benchmark of ``resnet_accel_tpu_torch`` on NVIDIA cards.

    python3 -m cardbench.run --workload NAME --seed N --seconds S --trace 0|1

runs one cell of ``BENCHMARK.json`` from the root of a checkout on the
card(s) the cell asks for, and prints one JSON object as the last line of
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
compared number with its limit, which also close standard error.  It
exits non-zero and prints no result without enough CUDA cards, or when
JAX or the JAX package was loaded in the process.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

#: Top-level module names the run must not have loaded.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "resnet_accel_tpu"})


def forbidden_loaded(modules=None) -> list:
    """Forbidden top-level names among ``modules`` (``sys.modules``),
    compared whole: ``resnet_accel_tpu_torch`` is not ``resnet_accel_tpu``."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cardbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from cardbench import harness
    bench = harness.load_bench()
    cell, config, traffic = harness.resolve(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"cardbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = harness.run_cell(bench, cell, config, traffic, args.seed,
                           args.seconds, bool(args.trace), "cuda:0", T_START)
    bad = forbidden_loaded()
    if bad:
        print(f"cardbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, value, limit in out.checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(out.result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
