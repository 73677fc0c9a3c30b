"""Smoke run of the PyTorch port on one CUDA card: INT8 ResNet-18 serving.

    python3 chip_smoke.py

Needs one card, nvcc and the repo checkout; exits non-zero (and prints no
result line) without them.  Phases, each fatal on failure:

1. Build the three kernels from ``resnet_accel_tpu_torch/csrc`` with nvcc.
2. Hold each kernel against its plain PyTorch version on the card, bit for
   bit, at the main path's shapes and values: a seed-0 ResNet-18
   (ImageNet geometry, 1000 classes), quantized and calibrated on the CPU,
   serving a batch of 128 images of 224 x 224 -- the stem (K1), every conv
   of the trunk including the residual joins (K2) and the fc layer (K3).
   Prints the median kernel and plain times (CUDA events).
3. Serve three batches of 128 through ``InferenceEngine(device="cuda")``
   with every launch count reset to 0 just before; each kernel must have
   launched.  The logits must be finite, [128, 1000], bit-identical to the
   plain path on the card, and for two images bit-identical to the plain
   path on the CPU.  Prints img/s (CUDA events, median forward).
4. Run ``python -m resnet_accel_tpu_torch infer --device cuda`` once.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Every time printed is labelled with the
card's name and power limit.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

BATCH = 128
HW = 224
CLASSES = 1000
SEED = 0


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    raise SystemExit(1)


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[torch.cuda.current_device()].strip()


def time_ms(fn, iters: int) -> float:
    """Median device time of ``fn`` over ``iters`` runs, after one warm-up
    (CUDA events around each run)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs a card")
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "resnet_accel_tpu_torch")):
        fail(f"no resnet_accel_tpu_torch package beside {__file__}")
    sys.path.insert(0, repo)
    from resnet_accel_tpu_torch import _kernels
    from resnet_accel_tpu_torch.models.resnet18 import (
        ResNet18Int8Module, init_resnet18_fp32, quantize_resnet18)
    from resnet_accel_tpu_torch.ops import (
        conv2d_int8, conv2d_int8_plain, matmul_int8, matmul_int8_plain,
        stem_conv_pool, stem_conv_pool_plain, avgpool_global_int8)
    from resnet_accel_tpu_torch.runtime.engine import InferenceEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    label = card_label()
    print(label)  # name, power limit: as nvidia-smi prints them
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # ---- 1. build ----------------------------------------------------
    t0 = time.perf_counter()
    _kernels.build(verbose=True)
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")

    # ---- model and inputs (seeded, calibrated on the CPU) -------------
    rng = np.random.default_rng(SEED)
    calib = rng.normal(0, 1, (2, 3, HW, HW)).astype(np.float32)
    t0 = time.perf_counter()
    model = quantize_resnet18(
        init_resnet18_fp32(seed=SEED, num_classes=CLASSES), calib, CLASSES)
    print(f"quantize + calibrate on the CPU: "
          f"{time.perf_counter() - t0:.1f} s")
    batches = [rng.normal(0, 1, (BATCH, 3, HW, HW)).astype(np.float32)
               for _ in range(3)]
    mod = ResNet18Int8Module(model, dev).eval()
    x = torch.from_numpy(batches[0]).to(dev)

    # ---- 2. each kernel against its plain version ---------------------
    stats = {k: {"ms": 0.0, "plain_ms": 0.0, "err": 0.0}
             for k in _kernels.KERNELS}

    def check(kernel, name, fn, plain, shape, iters=10, plain_iters=3):
        got, want = fn(), plain()
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        ms, pms = time_ms(fn, iters), time_ms(plain, plain_iters)
        s = stats[kernel]
        s["ms"] += ms
        s["plain_ms"] += pms
        s["err"] = max(s["err"], err)
        print(f"{kernel:12s} {name:6s} {shape:42s} equal={err == 0.0} "
              f"kernel {ms:.4f} ms  plain {pms:.4f} ms  ({label})")
        if err != 0.0 or got.shape != want.shape:
            fail(f"{kernel} {name}: kernel != plain (max |err| {err})")
        return want

    with torch.inference_mode():
        st = mod.stem
        a = check("stem_fused", "stem",
                  lambda: stem_conv_pool(x, st.weight, st.bias, st.factors,
                                         mod.s_input),
                  lambda: stem_conv_pool_plain(x, st.weight, st.bias,
                                               st.factors, mod.s_input),
                  f"x{list(x.shape)} fp32")
        for i, (convs, rs) in enumerate(zip(mod.blocks, mod.res_scales)):
            def conv_case(tag, cv, inp, **join):
                shape = (f"x{list(inp.shape)} k{cv.weight.shape[-1]} "
                         f"s{cv.stride} O{cv.weight.shape[0]}"
                         + (" +join" if join else ""))
                return check(
                    "conv_int8", f"b{i}.{tag}",
                    lambda: cv(inp, conv2d_int8, **join),
                    lambda: cv(inp, conv2d_int8_plain, **join), shape)
            y = conv_case("c1", convs["c1"], a)
            r = conv_case("ds", convs["ds"], a) if "ds" in convs else a
            a = conv_case("c2", convs["c2"], y, residual=r, res_scales=rs)
        p = avgpool_global_int8(a)
        check("matmul_int8", "fc",
              lambda: matmul_int8(p, mod.fc_w, bias=mod.fc_b),
              lambda: matmul_int8_plain(p, mod.fc_w, bias=mod.fc_b),
              f"a{list(p.shape)} b{list(mod.fc_w.shape)} int32")

    # ---- 3. the slice through the engine ------------------------------
    engine = InferenceEngine(model, device="cuda")
    _kernels.reset_launch_counts()
    results = [engine.run_inference(xb) for xb in batches]
    launches = _kernels.launch_counts()
    print(f"launch counts over {len(batches)} batches of {BATCH}: "
          f"{launches}")
    for name, n in launches.items():
        if n == 0:
            fail(f"kernel {name} was never launched by the main path")
    with torch.inference_mode():
        for b, (xb, res) in enumerate(zip(batches, results)):
            if res.logits.shape != (BATCH, CLASSES) or \
                    not np.isfinite(res.logits).all():
                fail(f"batch {b}: logits {res.logits.shape} not finite "
                     f"[{BATCH}, {CLASSES}]")
            plain = engine.module.forward_plain(
                torch.from_numpy(xb).to(dev)).cpu().numpy()
            if not np.array_equal(res.logits, plain):
                fail(f"batch {b}: logits differ from the plain path "
                     f"(max |err| {np.abs(res.logits - plain).max()})")
        cpu = ResNet18Int8Module(model, "cpu")(
            torch.from_numpy(batches[0][:2])).numpy()
    if not np.array_equal(results[0].logits[:2], cpu):
        fail("logits differ from the plain path on the CPU")
    print(f"logits: {len(batches)} x [{BATCH}, {CLASSES}] finite, "
          f"bit-identical to the plain path on the card and (2 images) "
          f"on the CPU; top-1 of batch 0: {results[0].predictions[:8]}")
    bench = engine.benchmark(batches[0], iters=10)
    print(f"forward batch {BATCH}: {bench.latency_s * 1e3:.3f} ms median, "
          f"{bench.images_per_s:.1f} img/s; run_inference incl. copies: "
          f"{[round(r.images_per_s, 1) for r in results]} img/s  "
          f"({label})")

    # ---- 4. the CLI -----------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "x.npy")
        np.save(path, np.random.default_rng(1).normal(
            0, 1, (4, 3, HW, HW)).astype(np.float32))
        proc = subprocess.run(
            [sys.executable, "-m", "resnet_accel_tpu_torch", "infer",
             "--model", "resnet18", "--input", path, "--device", "cuda",
             "--limit", "4"], cwd=repo, capture_output=True, text=True,
            timeout=600)
    print(proc.stdout, end="")
    if proc.returncode != 0 or "sample 3:" not in proc.stdout:
        print(proc.stderr, file=sys.stderr)
        fail(f"CLI infer exited {proc.returncode}")

    kernels = [{"name": name, "route": "cuda", "source": k.source,
                "replaces": k.replaces, "launches": launches[name],
                "max_abs_err": stats[name]["err"],
                "ms": stats[name]["ms"], "plain_ms": stats[name]["plain_ms"]}
               for name, k in _kernels.KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
