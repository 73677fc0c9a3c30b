"""The ResNet family on the card: ResNet-18, -34, -50, -101 and -152.

Counterpart of ``tools/family_bench.py``.  For each depth at the
throughput geometry (batch 128, 224 x 224, seed 0, calibrated on two
``normal(0, 1)`` images): chained steady-state img/s
(``runtime.perf.median_pair_time`` of 1 and of 16 dependent forwards,
each fed by the last one's logits, CUDA events, 7 pairs: the basis of
``bench.py``), the device time of one forward by layer scope
(``runtime.xprof.profile_layers``) with its six largest scopes, GMACs an
image (``runtime.profile.profile_resnet18`` at batch 1) and the int8 MFU
against the ``h100`` row's 1,979 TOP/s.  Each depth's logits for the first
two images must equal the plain path's bit for bit, or the tool exits
non-zero.

    python -m resnet_accel_tpu_torch.tools.family_bench [18,34,50,101,152]
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from resnet_accel_tpu_torch.models.resnet import (init_resnet_fp32,
                                                  quantize_resnet)
from resnet_accel_tpu_torch.models.resnet18 import ResNet18Int8Module
from resnet_accel_tpu_torch.runtime import xprof
from resnet_accel_tpu_torch.runtime.backend import resolve_device
from resnet_accel_tpu_torch.runtime.perf import get_platform, median_pair_time
from resnet_accel_tpu_torch.runtime.profile import profile_resnet18
from resnet_accel_tpu_torch.tools import _common

DEPTHS = (18, 34, 50, 101, 152)
BATCH, CHAIN, ITERS = 128, 16, 7


def gmacs_per_image(model) -> float:
    """Multiply-accumulates of one image through the quantized model, in
    billions (``profile_resnet18`` at batch 1)."""
    macs = sum(r.total_ops for r in profile_resnet18(model, batch=1).records)
    return macs // 2 / 1e9


def bench_depth(depth: int, batch: int = BATCH, chain: int = CHAIN,
                iters: int = ITERS, hw: int = 224, device="cuda",
                check: int = 2, label: str = "") -> Dict:
    """One depth's row (the JAX tool's fields, with the seconds spent
    quantizing on the host and the plain path's agreement)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    fp32 = init_resnet_fp32(depth=depth, seed=0, small_input=False)
    calib = rng.normal(0, 1, (2, 3, hw, hw)).astype(np.float32)
    model = quantize_resnet(fp32, calib, depth=depth, small_input=False)
    quantize_s = time.perf_counter() - t0
    mod = ResNet18Int8Module(model, dev).eval()
    x = torch.from_numpy(rng.normal(0, 1, (batch, 3, hw, hw)).astype(
        np.float32)).to(dev)
    macs = gmacs_per_image(model) * 1e9

    with torch.inference_mode():
        got = mod(x)[:check].cpu().numpy()
        want = mod.forward_plain(x[:check]).cpu().numpy()
    same = bool(np.array_equal(got, want))
    if not same:
        raise SystemExit(f"ResNet-{depth}: logits differ from the plain "
                         f"path (max |err| {np.abs(got - want).max()})")

    def loop(n):
        @torch.inference_mode()
        def run(x0):
            carry = x0
            for _ in range(n):
                out = mod(carry)
                carry = carry + out.sum().to(carry.dtype) * 1e-30
            return carry[0, 0, 0, 0]
        return run

    l1, lc = loop(1), loop(chain)
    l1(x), lc(x)                # warm
    per_batch = median_pair_time(l1, lc, x, chain, iters)
    img_s = batch / per_batch
    agg, _ = xprof.profile_layers(mod, x)
    dev_us = sum(agg.values()) * 1e6
    top = sorted(agg.items(), key=lambda kv: -kv[1])[:6]
    mfu = img_s * 2 * macs / get_platform().peak_int8_ops
    row = {
        "depth": depth, "batch": batch, "img_per_s": img_s,
        "chained_ms": per_batch * 1e3, "xprof_device_us": dev_us,
        "xprof_img_per_s": batch / (dev_us * 1e-6) if dev_us else None,
        "gmacs_per_img": macs / 1e9, "mfu_int8": mfu,
        "top_scopes_us": {k: v * 1e6 for k, v in top},
        "plain_identical": same, "quantize_s": quantize_s,
    }
    print(f"ResNet-{depth}, batch {batch}: {img_s:.1f} img/s chained "
          f"({per_batch * 1e3:.4f} ms a forward), device {dev_us:.1f} us "
          f"by scope, {macs / 1e9:.3f} GMACs/img, MFU {100 * mfu:.2f} %, "
          f"logits of {check} images equal the plain path's"
          f"{_common.tag(label)}",
          flush=True)
    return row


def table(rows) -> str:
    lines = ["| depth | GMACs/img | img/s (chained) | device µs by scope "
             "| MFU (int8) | top sinks (µs) |", "|---|---|---|---|---|---|"]
    for r in rows:
        sinks = ", ".join(f"{k} {v:.1f}" for k, v in
                          list(r["top_scopes_us"].items())[:3])
        lines.append(f"| -{r['depth']} | {r['gmacs_per_img']:.3f} | "
                     f"{r['img_per_s']:.1f} | {r['xprof_device_us']:.1f} | "
                     f"{100 * r['mfu_int8']:.2f} % | {sinks} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = _common.parser(__doc__)
    p.add_argument("depths", nargs="?",
                   default=",".join(map(str, DEPTHS)))
    p.add_argument("--batch", type=int, default=BATCH)
    p.add_argument("--chain", type=int, default=CHAIN)
    p.add_argument("--iters", type=int, default=ITERS)
    args = p.parse_args(argv)
    dev, label = _common.start(args.device)
    rows = []
    for d in (int(v) for v in args.depths.split(",")):
        t0 = time.perf_counter()
        rows.append(bench_depth(d, args.batch, args.chain, args.iters,
                                device=dev, label=label))
        print(f"[{time.perf_counter() - t0:6.1f} s] {rows[-1]}", flush=True)
    print(table(rows))
    _common.write_out(args.out, {"device": label, "batch": args.batch,
                                 "chain": args.chain, "rows": rows})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
