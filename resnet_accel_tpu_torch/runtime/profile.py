"""Per-layer roofline profile of the INT8 ResNet family.

Counterpart of ``resnet_accel_tpu/runtime/profile.py``: exact operations
and device-memory bytes of each layer from its geometry, the roofline
time of each on the H100 (``perf.get_platform``), and one measured
end-to-end latency distributed over the layers in proportion to those
times; ``layer_bounds``, each layer's bound with its weights read once a
batch, for the measured table.  ``runtime/xprof.py`` measures each
layer's device time instead.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from resnet_accel_tpu_torch.runtime.perf import (LayerProfiler, PerfMetrics,
                                                 get_platform)


def _conv_geometry(qc, h: int, w: int) -> Tuple[int, int, int, int, int]:
    """(H_out, W_out, MACs, activation bytes, weight bytes) of one conv
    layer on an H x W input, one image."""
    ho = (h + 2 * qc.padding - qc.kernel) // qc.stride + 1
    wo = (w + 2 * qc.padding - qc.kernel) // qc.stride + 1
    o = qc.w2d.shape[0]
    patch = qc.w2d.shape[1]
    macs = ho * wo * o * patch
    act = (h * w * qc.in_channels             # input int8
           + ho * wo * o)                      # output int8
    return ho, wo, macs, act, o * patch       # weights int8


def _rows(model, input_hw: int) -> List[Tuple[str, int, int, int]]:
    """(name, MACs, activation bytes, weight bytes) of each layer of one
    image."""
    rows: List[Tuple[str, int, int, int]] = []

    h = w = input_hw
    ho, wo, *geo = _conv_geometry(model.stem, h, w)
    rows.append(("stem", *geo))
    h, w = ho, wo
    if not model.small_input:
        h, w = (h + 2 * 1 - 3) // 2 + 1, (w + 2 * 1 - 3) // 2 + 1

    for i, blk in enumerate(model.blocks):
        ho, wo, *geo = _conv_geometry(blk.conv1, h, w)
        rows.append((f"b{i}.c1", *geo))
        ho, wo, *geo = _conv_geometry(blk.conv2, ho, wo)
        rows.append((f"b{i}.c2", *geo))
        if hasattr(blk, "conv3"):  # bottleneck (stride sits on conv2)
            ho, wo, *geo = _conv_geometry(blk.conv3, ho, wo)
            rows.append((f"b{i}.c3", *geo))
        if blk.downsample is not None:
            rows.append((f"b{i}.ds",
                         *_conv_geometry(blk.downsample, h, w)[2:]))
        h, w = ho, wo

    n_cls, feat = model.fc_w.shape
    rows.append(("fc", feat * n_cls, feat + n_cls, feat * n_cls))
    return rows


def profile_resnet18(model, input_hw: Optional[int] = None, batch: int = 1,
                     measured_latency_s: Optional[float] = None
                     ) -> LayerProfiler:
    """The per-layer profile of a quantized ``ResNet18Int8`` (any depth).

    Rows ``stem``, ``b{i}.c1``, ``b{i}.c2`` (``b{i}.c3`` for a bottleneck),
    ``b{i}.ds`` and ``fc``, each with its operations and bytes at
    ``batch``, weights counted once an image as the JAX package counts
    them.  ``measured_latency_s`` (e.g. ``InferenceEngine.benchmark``'s)
    is distributed over the rows by their roofline share; without it each
    row carries its roofline time.
    """
    if input_hw is None:
        input_hw = 32 if model.small_input else 224
    platform = get_platform()
    rows = [(name, macs, act + wt)
            for name, macs, act, wt in _rows(model, input_hw)]
    preds = [max(2 * macs * batch / platform.peak_int8_ops,
                 byt * batch / platform.hbm_bytes_per_s)
             for _, macs, byt in rows]
    scale = (measured_latency_s / sum(preds) if measured_latency_s
             else 1.0)
    prof = LayerProfiler()
    for (name, macs, byt), t_pred in zip(rows, preds):
        prof.add(PerfMetrics(name=name, latency_s=t_pred * scale,
                             total_ops=2 * macs * batch,
                             bytes_accessed=byt * batch, platform=platform))
    return prof


def layer_bounds(model, input_hw: Optional[int] = None,
                 batch: int = 1) -> Dict[str, float]:
    """Each layer's roofline bound on the H100 at ``batch``, seconds, by
    ``profile_resnet18``'s row names: the larger of its operations over
    the int8 peak and its bytes over HBM's rate, with each image's input
    and output counted and the weights once a batch, as one forward reads
    them."""
    if input_hw is None:
        input_hw = 32 if model.small_input else 224
    platform = get_platform()
    return {name: max(2 * macs * batch / platform.peak_int8_ops,
                      (act * batch + wt) / platform.hbm_bytes_per_s)
            for name, macs, act, wt in _rows(model, input_hw)}


def profile_table(prof: LayerProfiler) -> str:
    """Fixed-width per-layer table."""
    lines = [f"{'layer':10s} {'us':>9s} {'GOPS':>9s} {'util%':>7s} "
             f"{'GB/s':>8s} {'bound':>8s}"]
    for r in prof.records:
        lines.append(
            f"{r.name:10s} {r.latency_s * 1e6:9.1f} {r.gops:9.1f} "
            f"{r.utilization * 100:7.2f} {r.bandwidth_gbs:8.1f} "
            f"{r.roofline_bound:>8s}")
    s = prof.summary()
    lines.append(f"{'TOTAL':10s} {s['total_latency_s'] * 1e6:9.1f} "
                 f"{s['overall_gops']:9.1f}")
    return "\n".join(lines)
