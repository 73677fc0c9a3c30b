"""Command-line interface.

    infer     run INT8 inference (a ResNet of the family -- 18, 34, 50,
              101 or 152 -- or the MNIST CNN) on an .npy array of images
    bench     dense-vs-sparse GEMM sweep through the zero-skip kernel, or
              with --conv the zero-skip conv against the dense conv
    generate  greedy decoding on the INT8 block-sparse decoder LM
    profile   per-layer table of a ResNet of the family: the measured
              forward over the layers' roofline times, or with --measured
              each layer's device time from a torch.profiler trace beside
              its roofline bound

Every subcommand runs on the card unless ``--device cpu`` asks for the CPU.

Usage: python -m resnet_accel_tpu_torch infer --model resnet --depth 50 \\
           --input x.npy
       python -m resnet_accel_tpu_torch infer --model resnet18 --input x.npy
       python -m resnet_accel_tpu_torch infer --model mnist \\
           --weights int8_dir --input digits.npy
       python -m resnet_accel_tpu_torch bench
       python -m resnet_accel_tpu_torch bench --conv
       python -m resnet_accel_tpu_torch generate --flash --prompt 1,2,3
       python -m resnet_accel_tpu_torch profile --measured --batch 128
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import Optional, Sequence

import numpy as np


def cmd_infer(args) -> int:
    from resnet_accel_tpu_torch.runtime.engine import (InferenceEngine,
                                                       preprocess_mnist)

    x = np.load(args.input)
    if args.model != "resnet" and args.depth is not None:
        print(f"warning: --depth {args.depth} is ignored with --model "
              f"{args.model} (use --model resnet)", file=sys.stderr)
    if args.model == "mnist":
        from resnet_accel_tpu_torch.models.mnist_cnn import MNISTCNNInt8
        if args.weights is None:
            raise SystemExit("--model mnist needs --weights DIR (the int8 "
                             "export: {layer}_weight_int8.npy, ...)")
        model = MNISTCNNInt8.from_int8_dir(args.weights, x)
        if x.ndim == 3:
            x = preprocess_mnist(x.astype(np.uint8))
    else:
        from resnet_accel_tpu_torch.models.resnet import (init_resnet_fp32,
                                                          quantize_resnet)
        x = x.astype(np.float32)
        depth = (args.depth or 18) if args.model == "resnet" else 18
        fp32 = init_resnet_fp32(depth, seed=0, num_classes=args.num_classes,
                                small_input=args.small_input)
        model = quantize_resnet(fp32, x[:4], depth, args.num_classes,
                                small_input=args.small_input)
    eng = InferenceEngine(model, device=args.device)
    res = eng.run_inference(x[:args.limit])
    for i, (pred, t5) in enumerate(zip(res.predictions, res.top5)):
        top = ", ".join(f"{c}:{p:.3f}" for c, p in t5[:3])
        print(f"sample {i}: class {pred}  (top3: {top})")
    print(f"{res.images_per_s:.1f} images/s on {eng.device}")
    return 0


def _median_time_s(fn, iters: int, device) -> float:
    """Median time of one ``fn()`` after a warm-up: on a card, CUDA events
    recorded behind a spin of the card (about 2.5 ms), so that the host has
    queued ``fn`` before the start event fires and only device time
    counts; on the CPU, the host clock."""
    import torch
    fn()
    times = []
    for _ in range(iters):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(5_000_000)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return statistics.median(times)


#: The conv sweep's cases, (name, C, O, H, kernel, stride, padding): the
#: strided convs of ResNet-18 at ImageNet widths (``tools/tune_tpu.py``).
CONV_CASES = [
    ("l3.c1 3x3 s2", 128, 256, 28, 3, 2, 1),
    ("l3.ds 1x1 s2", 128, 256, 28, 1, 2, 0),
    ("l4.c1 3x3 s2", 256, 512, 14, 3, 2, 1),
    ("l4.ds 1x1 s2", 256, 512, 14, 1, 2, 0),
]


def device_label(dev) -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them (it
    ships with the driver; a failure to run it raises), or ``cpu``."""
    import subprocess
    if dev.type != "cuda":
        return "cpu"
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return lines[dev.index or 0].strip()


def cmd_bench_conv(args) -> int:
    """The zero-skip conv (K8) against the dense conv (K2) on the same
    weights at ResNet-18's strided convs: seeded int8 inputs, tap-block
    sparse weights (``--sparsity`` of the 128-wide blocks zeroed), factors
    0.001 with ReLU; median time of ``--iters`` runs each.  One JSON line a
    case."""
    import torch
    from resnet_accel_tpu_torch.ops import (conv2d_int8, pack_weight,
                                            sparse_conv2d_int8)
    from resnet_accel_tpu_torch.runtime.backend import resolve_device
    from resnet_accel_tpu_torch.sparse import (device_pack, pack_conv_bsr,
                                               tap_sparse_weight)

    dev = resolve_device(args.device)
    label = device_label(dev)
    rng = np.random.default_rng(1)
    N = args.batch if args.batch > 0 else 64
    rows = []
    with torch.inference_mode():
        for name, C, O, H, k, s, p in CONV_CASES:
            x = torch.from_numpy(
                rng.integers(-128, 128, (N, C, H, H)).astype(np.int8)).to(
                dev).contiguous(memory_format=torch.channels_last)
            w = tap_sparse_weight(rng, O, C, k, args.sparsity)
            fct = torch.full((O,), 0.001, dtype=torch.float32, device=dev)
            zero = torch.zeros(O, dtype=torch.int32, device=dev)
            wd = pack_weight(w.reshape(O, -1), C, k, dev)
            cbsr = pack_conv_bsr(w, padding=p)
            packed = device_pack(cbsr, dev)
            td = _median_time_s(lambda: conv2d_int8(
                x, wd, zero, fct, stride=s, padding=p, relu=True),
                args.iters, dev)
            ts = _median_time_s(lambda: sparse_conv2d_int8(
                x, packed, factors=fct, relu=True, stride=s),
                args.iters, dev)
            row = {"kind": "conv", "case": name, "batch": N,
                   "sparsity": round(cbsr.sparsity, 3),
                   "nnz_blocks": cbsr.nnz_source,
                   "total_blocks": cbsr.total_source,
                   "dense_ms": td * 1e3, "sparse_ms": ts * 1e3,
                   "speedup_vs_dense": td / ts, "device": label}
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.output:
        with open(args.output, "w") as f:
            json.dump({"device": label, "rows": rows}, f, indent=2)
    return 0


def cmd_bench(args) -> int:
    """Sizes x sparsities sweep: a square int8 W with 128 x 128 blocks
    zeroed at random, through ``bsr_matmul_wt``; latency, GOPS over the
    stored blocks and the speedup against the first sparsity (dense).
    ``max_row_blocks`` is the fullest block row's count: the kernel's
    blocks each walk one block row, so it bounds the time."""
    if args.conv:
        return cmd_bench_conv(args)
    import torch
    from resnet_accel_tpu_torch.ops import bsr_matmul_wt, pack_bsr
    from resnet_accel_tpu_torch.runtime.backend import resolve_device
    from resnet_accel_tpu_torch.sparse import build_bsr_int8_direct

    dev = resolve_device(args.device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"bench on {name}")
    rng = np.random.default_rng(0)
    sizes = [int(s) for s in args.sizes.split(",")]
    sparsities = [float(s) for s in args.sparsities.split(",")]
    M = args.batch if args.batch > 0 else 512
    rows = []
    with torch.inference_mode():
        for n in sizes:
            base_dt = cpu_dt = None
            if not args.no_cpu_baseline:
                # numpy int32 GEMM on the host, best of 3 after a warm-up
                Wc = rng.integers(-128, 128, (n, n)).astype(np.int32)
                Ac = rng.integers(-128, 128, (M, n)).astype(np.int32)
                _ = Ac @ Wc.T
                cpu_dt = float("inf")
                for _ in range(3):
                    t0 = time.perf_counter()
                    _ = Ac @ Wc.T
                    cpu_dt = min(cpu_dt, time.perf_counter() - t0)
            for sp in sparsities:
                W = rng.integers(-128, 128, (n, n)).astype(np.int8)
                nb = n // 128
                mask = rng.random((nb, nb)) < sp
                W[np.repeat(np.repeat(mask, 128, 0), 128, 1)] = 0
                packed = pack_bsr(build_bsr_int8_direct(W, 128), dev)
                A = torch.from_numpy(
                    rng.integers(-128, 128, (M, n)).astype(np.int8)).to(dev)
                dt = _median_time_s(lambda: bsr_matmul_wt(A, packed),
                                    args.iters, dev)
                if base_dt is None:
                    base_dt = dt
                row = {"M": M, "N": n, "K": n, "sparsity": sp,
                       "nnz_blocks": packed.nnz_source,
                       "max_row_blocks": packed.max_row_blocks,
                       "latency_us": dt * 1e6,
                       "gops": 2 * M * packed.nnz_source * 128 * 128
                       / dt / 1e9,
                       "speedup_vs_dense": base_dt / dt}
                if cpu_dt is not None:
                    row["speedup_vs_cpu"] = cpu_dt / dt
                rows.append(row)
                print(row)
    if args.output:
        with open(args.output, "w") as f:
            json.dump({"device": name, "rows": rows}, f, indent=2)
    return 0


def cmd_generate(args) -> int:
    """Greedy decoding on a seeded INT8 block-sparse decoder LM: static
    scales calibrated on ``min(16, max_len)`` seeded tokens, the prompt's
    KV caches filled by one causal forward per block (through K5 with
    ``--flash``), then a decode loop."""
    from resnet_accel_tpu_torch.models.lm import TransformerLMInt8

    lm = TransformerLMInt8.from_random(
        vocab=args.vocab, d_model=args.d_model, n_heads=args.heads,
        d_ff=2 * args.d_model, n_layers=args.layers,
        max_len=args.max_len, sparsity=args.sparsity, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    calib = rng.integers(0, args.vocab,
                         min(16, args.max_len)).astype(np.int32)
    scales = lm.calibrate(calib)
    prompt = np.asarray(
        [int(t) for t in args.prompt.split(",")], np.int32)
    if prompt.size + args.n_new > args.max_len:
        raise SystemExit("prompt + n_new exceeds --max-len")
    module = lm.module(args.device)
    t0 = time.perf_counter()
    toks = module.generate(prompt, args.n_new, scales, flash=args.flash)
    dt = time.perf_counter() - t0
    print(f"prompt:    {prompt.tolist()}")
    print(f"generated: {toks.tolist()}")
    mean_sp = float(np.mean(
        list(lm.blocks[0].sparsity_report().values())))
    print(f"{args.n_new} tokens in {dt:.2f}s on {module.device}; "
          f"sparsity {mean_sp:.0%} per projection")
    return 0


def cmd_profile(args) -> int:
    """Per-layer profile of a seed-0 INT8 ResNet (``--depth``), calibrated
    on two seeded images: the roofline table with the measured forward
    distributed over it, or with ``--measured`` each layer's measured time
    (device time on a card; ``runtime.xprof``) beside its roofline bound
    (``runtime.profile``)."""
    import torch
    from resnet_accel_tpu_torch.models.resnet import (init_resnet_fp32,
                                                      quantize_resnet)
    from resnet_accel_tpu_torch.runtime import xprof
    from resnet_accel_tpu_torch.runtime.engine import InferenceEngine
    from resnet_accel_tpu_torch.runtime.profile import profile_resnet18

    rng = np.random.default_rng(0)
    hw = 32 if args.small_input else 224
    fp32 = init_resnet_fp32(args.depth, seed=0, num_classes=args.num_classes,
                            small_input=args.small_input)
    calib = rng.normal(0, 1, (2, 3, hw, hw)).astype(np.float32)
    model = quantize_resnet(fp32, calib, args.depth, args.num_classes,
                            small_input=args.small_input)
    eng = InferenceEngine(model, device=args.device)
    x = rng.normal(0, 1, (args.batch, 3, hw, hw)).astype(np.float32)
    label = device_label(eng.device)
    if args.measured:
        xt = torch.from_numpy(x).to(eng.device)
        agg, _ = xprof.profile_layers(eng.module, xt)
        bounds = {r.name: r.latency_s for r in profile_resnet18(
            model, input_hw=hw, batch=args.batch).records}
        print(xprof.layer_table(agg, bounds))
    else:
        print(eng.profile(x, iters=args.iters))
    print(f"ResNet-{args.depth}, batch {args.batch}, {hw}x{hw}, "
          f"{'device' if eng.device.type == 'cuda' else 'host'} time on "
          f"{label}; bounds on the H100's published peaks")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m resnet_accel_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    pi = sub.add_parser("infer", help="run INT8 inference")
    pi.add_argument("--model", choices=["resnet18", "resnet", "mnist"],
                    default="resnet18")
    pi.add_argument("--depth", type=int, default=None,
                    choices=[18, 34, 50, 101, 152],
                    help="ResNet depth for --model resnet (default 18)")
    pi.add_argument("--weights", default=None,
                    help="mnist: directory of the int8 export")
    pi.add_argument("--input", required=True,
                    help=".npy images: float32 NCHW, or for mnist raw "
                         "[N, 28, 28] pixels")
    pi.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    pi.add_argument("--limit", type=int, default=8)
    pi.add_argument("--num-classes", type=int, default=1000)
    pi.add_argument("--small-input", action="store_true",
                    help="CIFAR geometry: 3x3 stem, no max pool")
    pi.set_defaults(fn=cmd_infer)

    pb = sub.add_parser("bench", help="dense-vs-sparse GEMM or conv sweep")
    pb.add_argument("--conv", action="store_true",
                    help="the zero-skip conv against the dense conv at "
                         "ResNet-18's strided convs")
    pb.add_argument("--sparsity", type=float, default=0.7,
                    help="--conv only: share of the tap blocks zeroed")
    pb.add_argument("--sizes", default="2048,4096",
                    help="GEMM sweep only (--conv ignores it)")
    pb.add_argument("--sparsities", default="0.0,0.5,0.7,0.9",
                    help="GEMM sweep only (--conv ignores it)")
    pb.add_argument("--batch", type=int, default=0,
                    help="rows M (0 = 512); --conv: images (0 = 64)")
    pb.add_argument("--iters", type=int, default=5)
    pb.add_argument("--output", default=None)
    pb.add_argument("--no-cpu-baseline", action="store_true",
                    help="skip the numpy int32 GEMM column (--conv has "
                         "none)")
    pb.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    pb.set_defaults(fn=cmd_bench)

    pg = sub.add_parser("generate",
                        help="greedy decode on the INT8 sparse LM")
    pg.add_argument("--prompt", default="1,2,3",
                    help="comma-separated token ids")
    pg.add_argument("--n-new", type=int, default=8)
    pg.add_argument("--layers", type=int, default=2)
    pg.add_argument("--d-model", type=int, default=128)
    pg.add_argument("--heads", type=int, default=4)
    pg.add_argument("--vocab", type=int, default=64)
    pg.add_argument("--max-len", type=int, default=64)
    pg.add_argument("--sparsity", type=float, default=0.8)
    pg.add_argument("--seed", type=int, default=0)
    pg.add_argument("--flash", action="store_true",
                    help="flash-attention prefill (kernel K5)")
    pg.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    pg.set_defaults(fn=cmd_generate)

    pp = sub.add_parser("profile", help="per-layer profile of a ResNet")
    pp.add_argument("--depth", type=int, default=18,
                    choices=[18, 34, 50, 101, 152])
    pp.add_argument("--measured", action="store_true",
                    help="each layer's measured time from a torch.profiler "
                         "trace (device time on a card) beside its "
                         "roofline bound")
    pp.add_argument("--batch", type=int, default=32)
    pp.add_argument("--num-classes", type=int, default=1000)
    pp.add_argument("--small-input", action="store_true",
                    help="CIFAR geometry: 3x3 stem, no max pool")
    pp.add_argument("--iters", type=int, default=3)
    pp.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    pp.set_defaults(fn=cmd_profile)
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
