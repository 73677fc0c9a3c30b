"""Command-line interface.

    infer     run INT8 ResNet-18 inference on an .npy array of images

Usage: python -m resnet_accel_tpu_torch infer --model resnet18 \\
           --input x.npy --device cuda
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np


def cmd_infer(args) -> int:
    from resnet_accel_tpu_torch.models.resnet18 import (init_resnet18_fp32,
                                                        quantize_resnet18)
    from resnet_accel_tpu_torch.runtime.engine import InferenceEngine

    x = np.load(args.input).astype(np.float32)
    fp32 = init_resnet18_fp32(seed=0, num_classes=args.num_classes,
                              small_input=args.small_input)
    model = quantize_resnet18(fp32, x[:4], args.num_classes,
                              small_input=args.small_input)
    eng = InferenceEngine(model, device=args.device)
    res = eng.run_inference(x[:args.limit])
    for i, (pred, t5) in enumerate(zip(res.predictions, res.top5)):
        top = ", ".join(f"{c}:{p:.3f}" for c, p in t5[:3])
        print(f"sample {i}: class {pred}  (top3: {top})")
    print(f"{res.images_per_s:.1f} images/s on {eng.device}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m resnet_accel_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    pi = sub.add_parser("infer", help="run INT8 inference")
    pi.add_argument("--model", choices=["resnet18"], default="resnet18")
    pi.add_argument("--input", required=True,
                    help=".npy float32 images, NCHW")
    pi.add_argument("--device", required=True, choices=["cuda", "cpu"])
    pi.add_argument("--limit", type=int, default=8)
    pi.add_argument("--num-classes", type=int, default=1000)
    pi.add_argument("--small-input", action="store_true",
                    help="CIFAR geometry: 3x3 stem, no max pool")
    pi.set_defaults(fn=cmd_infer)
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
