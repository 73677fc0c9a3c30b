"""Command-line interface.

    infer     run INT8 inference (a ResNet of the family -- 18, 34, 50,
              101 or 152 -- or the MNIST CNN) on an .npy array of images
    test      run the port's own tests (tests/test_torch_*.py)
    train     train the MNIST CNN on an IDX split, with --prune its
              progressive block pruning, into an FP32 checkpoint (.npz)
    bench     dense-vs-sparse GEMM sweep through the zero-skip kernel, with
              --conv the zero-skip conv against the dense conv, or with
              --artifact DIR one exported BSR layer's batch-1 matvec
    quantize  FP32 checkpoint (.npz) -> per-channel INT8 arrays
    export    a weight .npy -> a BSR layer directory
    sim       the golden model on a BSR layer directory (no card)
    verify    element-wise comparison of two .npy outputs (tolerance 0)
    fixtures  write the synthetic sparse fixture tree
    generate  decoding on the INT8 block-sparse decoder LM: greedy, or
              sampled with --temperature/--top-k, and with --speculative
              prompt-lookup speculative decoding
    serve     continuous-batching LM serving on the paged-KV engine, with
              --tp N sharded over N ranks (KV pools sliced by head)
    profile   per-layer table of a ResNet of the family: the measured
              forward over the layers' roofline times, or with --measured
              each layer's device time from a torch.profiler trace beside
              its roofline bound

``infer``, ``bench``, ``train``, ``generate``, ``serve`` and ``profile``
run on the card unless ``--device cpu`` asks for the CPU; ``quantize``,
``export``, ``sim``, ``verify`` and ``fixtures`` are numpy on the host.
The artifact flow:

    train --data mnist_raw/ --prune --output ck.npz
    quantize --checkpoint ck.npz --output int8/
    export --weights int8/fc1_weight_int8.npy --output fc1/ --name fc1
    sim --artifact fc1/ --output golden.npy
    verify --golden golden.npy --actual out.npy
    bench --artifact fc1/

Usage: python -m resnet_accel_tpu_torch infer --model resnet --depth 50 \\
           --input x.npy
       python -m resnet_accel_tpu_torch infer --model resnet18 --input x.npy
       python -m resnet_accel_tpu_torch infer --model mnist \\
           --weights int8_dir --input digits.npy
       python -m resnet_accel_tpu_torch bench
       python -m resnet_accel_tpu_torch bench --conv
       python -m resnet_accel_tpu_torch generate --flash --prompt 1,2,3
       python -m resnet_accel_tpu_torch generate --speculative \
           --temperature 0.8 --top-k 40
       python -m resnet_accel_tpu_torch serve --prompts "1,2,3;4,5"
       python -m resnet_accel_tpu_torch profile --measured --batch 128
"""

from __future__ import annotations

import argparse
import glob
import importlib.util
import json
import os
import pathlib
import re
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


#: A test file that imports JAX or the JAX package (or the tests'
#: conftest, which imports JAX).
_JAX_IMPORT = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|resnet_accel_tpu|conftest)\b", re.M)


def pytest_args(fail_fast: bool, jax_present: bool):
    """pytest's arguments for ``test`` and the line it prints first: every
    ``tests/test_torch_*.py`` where JAX can be imported; where it cannot,
    the files that import no JAX, without ``tests/conftest.py`` (which
    imports JAX)."""
    tests_dir = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests")
    files = sorted(glob.glob(os.path.join(tests_dir, "test_torch_*.py")))
    extra = ["-q"] + (["-x"] if fail_fast else [])
    if jax_present:
        return (files + extra,
                f"running the port's {len(files)} test files")
    files = [f for f in files
             if not _JAX_IMPORT.search(pathlib.Path(f).read_text())]
    return (["--noconftest"] + files + extra,
            f"jax is not installed: running the {len(files)} port test "
            f"files that import no JAX, without tests/conftest.py: "
            + ", ".join(os.path.basename(f) for f in files))


def cmd_test(args) -> int:
    import pytest
    argv, note = pytest_args(args.fail_fast,
                             importlib.util.find_spec("jax") is not None)
    print(note, flush=True)
    return int(pytest.main(argv))


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


class Chain:
    """``calls`` dependent calls of ``step`` on the buffer ``a``, run as one:
    on a card one replay of a CUDA graph captured here (make one eager call
    of ``step`` first, so nothing of a first launch is captured), on the
    CPU a loop.  ``runs`` counts the runs.  The wrappers count a launch
    when it is captured, not when it is replayed: a run on the card
    launches ``calls`` kernels that no count sees."""

    def __init__(self, step, a, calls: int):
        import torch
        self.step, self.a, self.calls, self.runs = step, a, calls, 0
        self.graph = None
        if a.device.type == "cuda":
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                for _ in range(calls):
                    step(a)

    def __call__(self, _x=None):
        self.runs += 1
        if self.graph is not None:
            self.graph.replay()
        else:
            for _ in range(self.calls):
                self.step(self.a)
        return self.a


def artifact_step(packed, fold: int):
    """One call of ``bench --artifact``'s chain: K4 on ``a``, the low bit
    of its first ``fold`` outputs added back into ``a``'s first ``fold``
    columns, in place (int8, wrapping), so that each call depends on the
    last and ``a`` stays the buffer whose address K4's TMA map holds."""
    from resnet_accel_tpu_torch.ops import bsr_matmul_wt

    def step(a):
        out = bsr_matmul_wt(a, packed)
        a[:, :fold].add_(out[:, :fold] & 1)   # int32 sum cast back: wraps
    return step


def cmd_bench_artifact(args) -> int:
    """One exported BSR layer directory (``export``'s, or the reference's
    ``bsr_export_14x14/fc1``: 90.9 us, 28.41 GOPS on its Verilator model):
    regrouped to 128 x 128 blocks and packed for K4; K4 on the activation
    ``((k + m) % 256) - 128`` (M rows: 1 unless ``--batch``) held against
    the golden bit for bit; then seconds a call, ``median_pair_time`` of a
    chain of 1 and of ``--chain`` dependent calls (``artifact_step``), each
    chain one CUDA graph on a card (device time, CUDA events) and a loop on
    the CPU (host time).  GOPS count ``2 * nnz * bh * bw * M`` over the
    layer's own blocks.  Prints one JSON row (``launches``: the K4 kernels
    run on the card, graph replays included); exits 1 unless bit-exact."""
    import torch
    from resnet_accel_tpu_torch.golden import bsr_matmul_int8_wt
    from resnet_accel_tpu_torch.ops import bsr_matmul_wt, pack_bsr
    from resnet_accel_tpu_torch.runtime.backend import resolve_device
    from resnet_accel_tpu_torch.runtime.perf import median_pair_time
    from resnet_accel_tpu_torch.sparse import load_layer_dir, regroup_bsr

    if args.chain < 2:
        raise SystemExit(f"--chain must be >= 2, got {args.chain}")
    dev = resolve_device(args.device)
    bsr = load_layer_dir(args.artifact)
    packed = pack_bsr(regroup_bsr(bsr, 128, 128), dev)
    K, n = bsr.shape[1], bsr.shape[0]
    M = args.batch if args.batch > 0 else 1
    act = ((np.arange(K)[None, :] + np.arange(M)[:, None]) % 256 - 128
           ).astype(np.int8)
    actp = np.pad(act, ((0, 0), (0, bsr.padded_shape[1] - K)))
    ref = bsr_matmul_int8_wt(actp, bsr.data, bsr.row_ptr, bsr.col_idx,
                             bsr.block_h, bsr.block_w)[:, :n]
    a = torch.from_numpy(act).to(dev)
    with torch.inference_mode():
        out = bsr_matmul_wt(a, packed)     # also the warm-up before capture
        exact = bool(np.array_equal(out.cpu().numpy(), ref))
        step = artifact_step(packed, min(K, n))
        l1, lc = Chain(step, a, 1), Chain(step, a, args.chain)
        dt = median_pair_time(l1, lc, a, args.chain, args.iters)
    ops = 2 * bsr.nnz_blocks * bsr.block_h * bsr.block_w * M
    row = {
        "artifact": args.artifact, "M": M, "K": K, "N": n,
        "nnz_blocks": bsr.nnz_blocks,
        "block": f"{bsr.block_h}x{bsr.block_w}",
        "bit_exact": exact,
        "latency_us": dt * 1e6,
        "gops": ops / dt / 1e9,
        "launches": (1 + l1.runs + lc.runs * lc.calls
                     if dev.type == "cuda" else 0),
        "device": device_label(dev),
    }
    print(json.dumps(row))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(row, f, indent=2)
    return 0 if exact else 1


def cmd_bench(args) -> int:
    """Sizes x sparsities sweep: a square int8 W with 128 x 128 blocks
    zeroed at random, through ``bsr_matmul_wt``; latency, GOPS over the
    stored blocks and the speedup against the first sparsity (dense).
    ``max_row_blocks`` is the fullest block row's count: the kernel's
    blocks each walk one block row, so it bounds the time."""
    if args.conv:
        return cmd_bench_conv(args)
    if args.artifact:
        return cmd_bench_artifact(args)
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


def cmd_train(args) -> int:
    """Train the MNIST CNN on an IDX split (Adam), optionally prune it
    progressively (fc1 at 128 x 128 blocks, fc2 at 8 x 8, the group lasso
    in each fine-tune), and save the npz checkpoint ``quantize`` reads."""
    from resnet_accel_tpu_torch.train import save_checkpoint, train_mnist
    from resnet_accel_tpu_torch.utils.mnist_data import load_mnist_split

    imgs, labels = load_mnist_split(args.data, args.split)
    res = train_mnist(imgs, labels, epochs=args.epochs,
                      batch_size=args.batch_size, lr=args.lr,
                      seed=args.seed, device=args.device)
    print(f"best eval acc: {res.best_acc:.4f}")
    if args.prune:
        from resnet_accel_tpu_torch.train import (
            BlockCfg, progressive_prune, sparsity_of_masks)
        cfgs = {"fc1.weight": BlockCfg(128, 128, 0.05),
                "fc2.weight": BlockCfg(8, 8, 0.05)}

        def finetune(params, mask_fn, reg_fn):
            r = train_mnist(imgs, labels, epochs=1,
                            batch_size=args.batch_size, seed=args.seed,
                            mask_fn=mask_fn, reg_fn=reg_fn, params=params,
                            device=args.device)
            print(f"  finetune acc: {r.best_acc:.4f}")
            return r.params

        pruned, masks = progressive_prune(
            res.params, finetune, cfgs,
            schedule=[float(s) for s in args.schedule.split(",")])
        res.params.update(pruned)
        print(f"final block sparsity: {sparsity_of_masks(masks):.1%}")
    if args.output:
        save_checkpoint(res, args.output)
        print(f"saved checkpoint to {args.output}")
    return 0


def cmd_quantize(args) -> int:
    """An FP32 checkpoint (``{layer}.weight`` / ``{layer}.bias`` arrays)
    quantized: per layer ``{layer}_{kind}_int8.npy`` beside
    ``_scales.npy`` (weights, per channel) or ``_scale.json`` (biases, per
    tensor), and ``quantization_metadata.json`` with each error; the layout
    ``infer --model mnist --weights`` reads."""
    from resnet_accel_tpu_torch.checkpoint import load_checkpoint
    from resnet_accel_tpu_torch.quant import quantize_params_per_channel

    q = quantize_params_per_channel(load_checkpoint(args.checkpoint))
    os.makedirs(args.output, exist_ok=True)
    metadata = {}
    for pname, pdata in q.items():
        lname = pname.replace(".", "_")
        np.save(os.path.join(args.output, f"{lname}_int8.npy"),
                pdata["data"])
        if "scales" in pdata:
            np.save(os.path.join(args.output, f"{lname}_scales.npy"),
                    pdata["scales"])
        else:
            with open(os.path.join(args.output,
                                   f"{lname}_scale.json"), "w") as f:
                json.dump({"scale": float(pdata["scale"])}, f)
        metadata[pname] = {
            "shape": list(pdata["shape"]),
            "quantization": "per_channel" if "scales" in pdata
            else "per_tensor",
            "error": pdata["error"],
        }
        print(f"quantized {pname}: shape {pdata['shape']} "
              f"SNR {pdata['error']['snr_db']:.1f} dB")
    with open(os.path.join(args.output,
                           "quantization_metadata.json"), "w") as f:
        json.dump(metadata, f, indent=2)
    return 0


def cmd_export(args) -> int:
    """A weight .npy (a 4-D conv weight is flattened to [O, I*kH*kW]) to a
    BSR layer directory: int8 as it is, float quantized per row with
    ``--scales`` or max|row| / 127."""
    from resnet_accel_tpu_torch.sparse import (build_bsr,
                                               build_bsr_int8_direct,
                                               save_layer_dir)

    w = np.load(args.weights)
    if w.ndim == 4:
        w = w.reshape(w.shape[0], -1)
    if w.dtype == np.int8:
        bsr = build_bsr_int8_direct(w, args.block_h, args.block_w)
    else:
        scales = (np.load(args.scales) if args.scales
                  else np.maximum(np.abs(w).max(axis=1) / 127.0, 1e-12))
        bsr = build_bsr(w, args.block_h, args.block_w,
                        threshold=args.threshold, quantize=True,
                        scales=scales)
    save_layer_dir(bsr, args.output, args.name)
    print(f"exported {args.name}: {bsr.nnz_blocks} blocks "
          f"({bsr.sparsity_pct:.1f}% sparse), "
          f"compression {bsr.compression_ratio():.1f}x")
    return 0


def cmd_sim(args) -> int:
    """The golden model on a BSR layer directory: one row of activations
    ``(k % 256) - 128`` over the padded K, every padded output."""
    from resnet_accel_tpu_torch.golden import bsr_matmul_int8_wt
    from resnet_accel_tpu_torch.sparse import load_layer_dir

    bsr = load_layer_dir(args.artifact)
    bsr.validate()
    K = bsr.padded_shape[1]
    act = ((np.arange(K) % 256) - 128).astype(np.int8).reshape(1, K)
    out = bsr_matmul_int8_wt(act, bsr.data, bsr.row_ptr, bsr.col_idx,
                             bsr.block_h, bsr.block_w)
    print(f"artifact: {args.artifact}")
    print(f"  shape {bsr.shape} padded {bsr.padded_shape} "
          f"blocks {bsr.nnz_blocks} ({bsr.sparsity_pct:.1f}% sparse)")
    print(f"  golden output[:8]: {out[0, :8].tolist()}")
    if args.output:
        np.save(args.output, out)
        print(f"  saved golden output to {args.output}")
    return 0


def cmd_verify(args) -> int:
    """Element-wise comparison of two .npy arrays within ``--tolerance``
    (default 0): PASS (exit 0), or FAIL (exit 1) with the first ten
    mismatches."""
    a = np.load(args.golden)
    b = np.load(args.actual)
    if a.shape != b.shape:
        print(f"FAIL: shape mismatch {a.shape} vs {b.shape}")
        return 1
    diff = np.abs(a.astype(np.int64) - b.astype(np.int64))
    n_bad = int((diff > args.tolerance).sum())
    print(f"compared {a.size} elements, tolerance {args.tolerance}")
    if n_bad == 0:
        print("PASS: outputs match")
        return 0
    idx = np.argwhere(diff > args.tolerance)[:10]
    print(f"FAIL: {n_bad} mismatches (max diff {int(diff.max())})")
    for i in idx:
        t = tuple(i)
        print(f"  at {t}: golden={a[t]} actual={b[t]}")
    return 1


def cmd_fixtures(args) -> int:
    """Write the synthetic sparse fixture tree (``sparse/fixtures.py``)."""
    from resnet_accel_tpu_torch.sparse.fixtures import generate_all_fixtures

    made = generate_all_fixtures(args.output, seed=args.seed)
    for k, v in made.items():
        print(f"  {k} -> {v}")
    print(f"generated {len(made)} fixtures under {args.output}")
    return 0


def _seeded_lm(args):
    """The seeded INT8 block-sparse decoder LM of ``generate`` and
    ``serve``, with static scales calibrated on ``min(16, max_len)`` seeded
    tokens."""
    from resnet_accel_tpu_torch.models.lm import TransformerLMInt8

    lm = TransformerLMInt8.from_random(
        vocab=args.vocab, d_model=args.d_model, n_heads=args.heads,
        d_ff=2 * args.d_model, n_layers=args.layers,
        max_len=args.max_len, sparsity=args.sparsity, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    calib = rng.integers(0, args.vocab,
                         min(16, args.max_len)).astype(np.int32)
    return lm, lm.calibrate(calib)


def cmd_generate(args) -> int:
    """Decoding on a seeded INT8 block-sparse decoder LM: the prompt's KV
    caches filled by one causal forward per block (through K5 with
    ``--flash``), then greedy decoding, sampling (``--temperature`` > 0,
    ``--top-k``, ``--sample-seed``) or, with ``--speculative``,
    prompt-lookup speculative decoding of ``--draft`` tokens a pass."""
    from resnet_accel_tpu_torch.models.lm import prng_key

    lm, scales = _seeded_lm(args)
    prompt = np.asarray(
        [int(t) for t in args.prompt.split(",")], np.int32)
    if prompt.size + args.n_new > args.max_len:
        raise SystemExit("prompt + n_new exceeds --max-len")
    module = lm.module(args.device)
    if args.temperature <= 0 and (args.top_k is not None
                                  or args.sample_seed != 0):
        print("warning: --top-k/--sample-seed have no effect with "
              "temperature 0 (greedy decoding); pass --temperature > 0 "
              "to sample", file=sys.stderr)
    key = prng_key(args.sample_seed) if args.temperature > 0 else None
    t0 = time.perf_counter()
    spec_steps = None
    if args.speculative:
        # a verify pass writes draft + 1 K/V rows past the final length:
        # shrink the draft to the headroom max_len leaves
        draft = min(args.draft, args.max_len - prompt.size - args.n_new)
        if draft < 1:
            raise SystemExit("--speculative needs at least 1 token of "
                             "--max-len headroom beyond prompt + n_new")
        if draft < args.draft:
            print(f"note: draft shrunk to {draft} (max-len headroom)",
                  file=sys.stderr)
        toks, spec_steps = module.generate_speculative(
            prompt, args.n_new, scales, draft=draft, flash=args.flash,
            return_stats=True, temperature=args.temperature,
            top_k=args.top_k, rng_key=key)
    elif args.temperature > 0:
        toks = module.sample(prompt, args.n_new, scales, key,
                             temperature=args.temperature, top_k=args.top_k,
                             flash=args.flash)
    else:
        toks = module.generate(prompt, args.n_new, scales, flash=args.flash)
    dt = time.perf_counter() - t0
    print(f"prompt:    {prompt.tolist()}")
    print(f"generated: {toks.tolist()}")
    if spec_steps is not None:
        basis = ("distribution-exact vs sample()"
                 if args.temperature > 0 else "identical to greedy")
        print(f"speculative: {int(spec_steps)} verify passes for "
              f"{args.n_new} tokens (outputs {basis})")
    mean_sp = float(np.mean(
        list(lm.blocks[0].sparsity_report().values())))
    print(f"{args.n_new} tokens in {dt:.2f}s on {module.device}; "
          f"sparsity {mean_sp:.0%} per projection")
    return 0


def _serve_tp(args, lm, scales, prompts, engine):
    """``serve --tp N``: the engine sharded over N spawned ranks (one
    ``PagedKVBatcher(tp_mesh=...)`` a rank, the KV pools sliced by head);
    every rank must return the same streams.  Returns rank 0's run."""
    from resnet_accel_tpu_torch.parallel import jobs
    from resnet_accel_tpu_torch.parallel.launch import (available_devices,
                                                        default_backend,
                                                        run_world)
    backend = args.dist_backend or default_backend(args.device)
    # over gloo the ranks may share a card; otherwise each needs a device
    if not (backend == "gloo" and args.device == "cuda"):
        have = available_devices(args.device)
        if have < args.tp:
            raise SystemExit(f"--tp {args.tp} needs {args.tp} devices, "
                             f"have {have}")
    reqs = [(p, args.n_new, args.sample_seed + i)
            for i, p in enumerate(prompts)]
    ranks = run_world(jobs.run_jobs, args.tp, device=args.device,
                      backend=backend, timeout_s=3600.0, args=(
                          args.device, [
                              ("world", jobs.world_info, ()),
                              ("serve", jobs.paged_tp, (
                                  {"tp": args.tp}, lm, scales, [reqs],
                                  engine))]))
    streams = [r["serve"]["streams"] for r in ranks]
    if any(s != streams[0] for s in streams):
        raise RuntimeError(f"tp ranks returned different streams: {streams}")
    return ranks[0]["serve"], ranks[0]["world"]


def cmd_serve(args) -> int:
    """Continuous-batching serving on the paged-KV engine: several requests
    admitted into lockstep decode lanes over a page pool, with sampling,
    on-demand pages, prefix caching, int8 KV pages and speculative decoding
    on the command line, and with ``--tp N`` the engine sharded over N
    ranks.  Prints each request's stream and the engine's counters."""
    from resnet_accel_tpu_torch.runtime.paged import PagedKVBatcher

    lm, scales = _seeded_lm(args)
    prompts = [[int(t) for t in p.split(",")]
               for p in args.prompts.split(";")]
    for p in prompts:
        if len(p) + args.n_new > args.max_len:
            raise SystemExit("prompt + n_new exceeds --max-len")
    engine = dict(
        slots=args.slots, page=args.page, pool_pages=args.pool_pages,
        chunk=args.chunk, temperature=args.temperature, top_k=args.top_k,
        reserve=args.reserve, prefix_cache=args.prefix_cache,
        kv_dtype=args.kv_dtype, spec_draft=args.spec_draft,
        spec_adaptive=args.spec_adaptive)
    if args.tp > 1:
        run, world = _serve_tp(args, lm, scales, prompts, engine)
        streams, dt, counters = (run["streams"][0], run["seconds"],
                                 run["counters"])
        pool_bytes = run["pool_bytes"]
        where = (f"{world['device']}, {args.tp} ranks over "
                 f"{world['backend']}")
    else:
        eng = PagedKVBatcher(lm, scales, device=args.device, **engine)
        rids = [eng.submit(p, args.n_new, seed=args.sample_seed + i)
                for i, p in enumerate(prompts)]
        t0 = time.perf_counter()
        res = eng.run()
        dt = time.perf_counter() - t0
        streams = [res[rid] for rid in rids]
        counters = {k: getattr(eng, k) for k in (
            "steps", "micro_steps", "cache_hits", "cache_tokens_skipped",
            "preemptions", "spec_switches")}
        pool_bytes = eng.kv_pool_bytes()
        where = str(eng.device)
    toks = 0
    for i, (p, stream) in enumerate(zip(prompts, streams)):
        print(f"req {i}: prompt {p} -> {stream}")
        toks += len(stream)
    bits = [f"{toks} tokens in {dt:.2f}s on {where}",
            f"{counters['steps']} engine steps / {counters['micro_steps']} "
            f"micro-steps",
            f"pool {pool_bytes / 1e6:.2f} MB ({args.kv_dtype})"]
    if args.prefix_cache:
        bits.append(f"cache hits {counters['cache_hits']} "
                    f"(+{counters['cache_tokens_skipped']} prefill skipped)")
    if counters["preemptions"]:
        bits.append(f"preemptions {counters['preemptions']}")
    if args.spec_adaptive:
        bits.append(f"spec mode switches {counters['spec_switches']}")
    if args.tp > 1:
        bits.append(f"tp={args.tp} (KV sliced by head)")
    print("; ".join(bits))
    return 0


def cmd_profile(args) -> int:
    """Per-layer profile of a seed-0 INT8 ResNet (``--depth``), calibrated
    on two seeded images: the roofline table with the measured forward
    distributed over it, or with ``--measured`` each layer's measured time
    (device time on a card; ``runtime.xprof``) beside its roofline bound
    with the weights read once a batch (``runtime.profile.layer_bounds``)."""
    import torch
    from resnet_accel_tpu_torch.models.resnet import (init_resnet_fp32,
                                                      quantize_resnet)
    from resnet_accel_tpu_torch.runtime import xprof
    from resnet_accel_tpu_torch.runtime.engine import InferenceEngine
    from resnet_accel_tpu_torch.runtime.profile import layer_bounds

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
        print(xprof.layer_table(agg, layer_bounds(model, input_hw=hw,
                                                  batch=args.batch)))
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

    pt = sub.add_parser("test", help="run the port's tests")
    pt.add_argument("--fail-fast", action="store_true")
    pt.set_defaults(fn=cmd_test)

    pb = sub.add_parser("bench", help="dense-vs-sparse GEMM or conv sweep")
    pb.add_argument("--conv", action="store_true",
                    help="the zero-skip conv against the dense conv at "
                         "ResNet-18's strided convs")
    pb.add_argument("--artifact", default=None, metavar="DIR",
                    help="one exported BSR layer directory instead of the "
                         "sweep (the reference's FC1 on its Verilator "
                         "model: 90.9 us, 28.41 GOPS)")
    pb.add_argument("--chain", type=int, default=256,
                    help="--artifact only: dependent calls a timed chain")
    pb.add_argument("--sparsity", type=float, default=0.7,
                    help="--conv only: share of the tap blocks zeroed")
    pb.add_argument("--sizes", default="2048,4096",
                    help="GEMM sweep only (--conv ignores it)")
    pb.add_argument("--sparsities", default="0.0,0.5,0.7,0.9",
                    help="GEMM sweep only (--conv ignores it)")
    pb.add_argument("--batch", type=int, default=0,
                    help="rows M (0 = 512; --artifact: 0 = 1); --conv: "
                         "images (0 = 64)")
    pb.add_argument("--iters", type=int, default=5)
    pb.add_argument("--output", default=None)
    pb.add_argument("--no-cpu-baseline", action="store_true",
                    help="skip the numpy int32 GEMM column (--conv has "
                         "none)")
    pb.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    pb.set_defaults(fn=cmd_bench)

    ptr = sub.add_parser("train", help="train the MNIST CNN")
    ptr.add_argument("--data", required=True,
                     help="directory of the MNIST IDX files (plain or .gz)")
    ptr.add_argument("--split", default="t10k")
    ptr.add_argument("--epochs", type=int, default=2)
    ptr.add_argument("--batch-size", type=int, default=128)
    ptr.add_argument("--lr", type=float, default=1e-3)
    ptr.add_argument("--seed", type=int, default=1917)
    ptr.add_argument("--prune", action="store_true")
    ptr.add_argument("--schedule", default="0.5,0.7,0.85,0.9")
    ptr.add_argument("--output", default=None)
    ptr.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ptr.set_defaults(fn=cmd_train)

    pq = sub.add_parser("quantize", help="FP32 checkpoint -> INT8")
    pq.add_argument("--checkpoint", required=True)
    pq.add_argument("--output", required=True)
    pq.set_defaults(fn=cmd_quantize)

    pe = sub.add_parser("export", help="weights -> BSR artifact")
    pe.add_argument("--weights", required=True, help=".npy weight matrix")
    pe.add_argument("--scales", default=None)
    pe.add_argument("--output", required=True)
    pe.add_argument("--name", default="layer")
    pe.add_argument("--block-h", type=int, default=14)
    pe.add_argument("--block-w", type=int, default=14)
    pe.add_argument("--threshold", type=float, default=1e-10)
    pe.set_defaults(fn=cmd_export)

    ps = sub.add_parser("sim", help="golden software model on artifact")
    ps.add_argument("--artifact", required=True)
    ps.add_argument("--output", default=None)
    ps.set_defaults(fn=cmd_sim)

    pv = sub.add_parser("verify",
                        help="element-wise output comparison (tol 0)")
    pv.add_argument("--golden", required=True)
    pv.add_argument("--actual", required=True)
    pv.add_argument("--tolerance", type=int, default=0)
    pv.set_defaults(fn=cmd_verify)

    pf = sub.add_parser("fixtures", help="regenerate sparse test fixtures")
    pf.add_argument("--output", required=True)
    pf.add_argument("--seed", type=int, default=42)
    pf.set_defaults(fn=cmd_fixtures)

    pg = sub.add_parser("generate", help="decode on the INT8 sparse LM")
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
    pg.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy)")
    pg.add_argument("--top-k", type=int, default=None,
                    help="top-k truncation for sampling")
    pg.add_argument("--sample-seed", type=int, default=0)
    pg.add_argument("--speculative", action="store_true",
                    help="prompt-lookup speculative decoding: greedy "
                         "outputs identical to generate; with "
                         "--temperature > 0, rejection-sampled "
                         "(distribution-exact vs sample); fewer "
                         "decode passes either way")
    pg.add_argument("--draft", type=int, default=15,
                    help="speculative draft length per verify pass")
    pg.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    pg.set_defaults(fn=cmd_generate)

    pv2 = sub.add_parser(
        "serve", help="continuous-batching LM serving (paged KV)")
    pv2.add_argument("--prompts", default="1,2,3;4,5;6,7,8,9",
                     help="semicolon-separated requests, each a "
                          "comma-separated token-id prompt")
    pv2.add_argument("--n-new", type=int, default=8)
    pv2.add_argument("--slots", type=int, default=2)
    pv2.add_argument("--page", type=int, default=8)
    pv2.add_argument("--pool-pages", type=int, default=24)
    pv2.add_argument("--chunk", type=int, default=8)
    pv2.add_argument("--reserve", default="full",
                     choices=["full", "ondemand"])
    pv2.add_argument("--prefix-cache", action="store_true")
    pv2.add_argument("--kv-dtype", default="fp32",
                     choices=["fp32", "int8"])
    pv2.add_argument("--spec-draft", type=int, default=0,
                     help="speculative verify window (0 = off)")
    pv2.add_argument("--spec-adaptive", action="store_true",
                     help="fall back to chunked steps while the measured "
                          "acceptance EWMA does not beat them (greedy "
                          "only)")
    pv2.add_argument("--temperature", type=float, default=0.0)
    pv2.add_argument("--top-k", type=int, default=None)
    pv2.add_argument("--sample-seed", type=int, default=0)
    pv2.add_argument("--tp", type=int, default=1,
                     help="shard the engine over a tp mesh of this many "
                          "ranks (KV pools sliced by head)")
    pv2.add_argument("--dist-backend", default=None,
                     choices=["gloo", "nccl"],
                     help="the ranks' backend with --tp (default: nccl on "
                          "cuda, a card a rank; gloo on the CPU; gloo on "
                          "cuda lets ranks share a card)")
    pv2.add_argument("--layers", type=int, default=2)
    pv2.add_argument("--d-model", type=int, default=128)
    pv2.add_argument("--heads", type=int, default=4)
    pv2.add_argument("--vocab", type=int, default=64)
    pv2.add_argument("--max-len", type=int, default=64)
    pv2.add_argument("--sparsity", type=float, default=0.8)
    pv2.add_argument("--seed", type=int, default=0)
    pv2.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    pv2.set_defaults(fn=cmd_serve)

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
