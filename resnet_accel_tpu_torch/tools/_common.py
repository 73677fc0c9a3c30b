"""What the tools share: the device and ``--out`` flags, the card's label,
host-clock timing between synchronizations, and the JSON record."""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Optional, Tuple

import torch

from resnet_accel_tpu_torch.ops.flash_attention import fp32_matmuls
from resnet_accel_tpu_torch.runtime.backend import resolve_device


def parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser with ``--device`` and ``--out``."""
    p = argparse.ArgumentParser(
        description=doc.strip().splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    p.add_argument("--out", default=None,
                   help="write the results as JSON to this file")
    return p


def start(device) -> Tuple[torch.device, str]:
    """The device (TF32 off for float32 products, as the JAX package
    computes them at HIGHEST precision) and its label: the card's name and
    power limit as ``nvidia-smi`` prints them, or ``cpu``."""
    from resnet_accel_tpu_torch.cli import device_label
    dev = resolve_device(device)
    fp32_matmuls()
    label = device_label(dev)
    print(label, flush=True)
    return dev, label


def sync(dev: Optional[torch.device]) -> None:
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn: Callable, dev, *args, **kw):
    """A warm call of ``fn``, then a timed one: (its result, seconds on the
    host clock between synchronizations of ``dev``)."""
    fn(*args, **kw)
    sync(dev)
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    sync(dev)
    return out, time.perf_counter() - t0


def write_out(path: Optional[str], results: dict) -> None:
    if path:
        with open(path, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {path}", flush=True)


def tag(label: str) -> str:
    """``label`` as the suffix of a printed measurement, or nothing."""
    return f"  ({label})" if label else ""
