"""The attribution copy, the busy union and the readers on a synthetic
Chrome trace."""

import pytest

from cardbench import trace
from cardbench.context import TraceContext, roofline_share
from cardbench.harness import reader
from cardbench.work.resnet_int8 import Layer, bound_s

HOST = dict(pid=1, tid=7)


def X(cat, name, ts, dur, corr=None, **where):
    e = dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, **(where or HOST))
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def dev(cat, name, ts, dur, corr):
    return X(cat, name, ts, dur, corr, pid=0, tid=3)


def events():
    return [
        X("user_annotation", "cardbench.slice", 100.0, 900.0),
        X("user_annotation", "b0.c1", 110.0, 100.0),
        X("user_annotation", "b0.c3", 220.0, 100.0),
        X("cuda_runtime", "cudaMemcpyAsync", 105.0, 2.0, corr=1),
        X("cuda_runtime", "cudaLaunchKernel", 120.0, 3.0, corr=2),
        X("cuda_runtime", "cudaLaunchKernel", 230.0, 3.0, corr=3),
        X("cuda_runtime", "cudaLaunchKernel", 240.0, 3.0, corr=4),  # lost
        X("cuda_runtime", "cudaLaunchKernel", 50.0, 3.0, corr=5),   # before
        X("cpu_op", "aten::copy_", 400.0, 300.0),
        dev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 110.0, 90.0, 1),
        dev("kernel", "conv_k2", 200.0, 200.0, 2),
        dev("kernel", "expand_k7", 350.0, 150.0, 3),
        dev("kernel", "spin", 60.0, 20.0, 5),
    ]


def test_attribution_by_scope_and_lost_launches():
    att = trace.attribute(events(), "cardbench.slice")
    got = {(o.name, o.scope): (o.seconds, o.count) for o in att.ops}
    assert got == {
        ("Memcpy HtoD (Pinned -> Device)", ""): (pytest.approx(90e-6), 1),
        ("conv_k2", "b0.c1"): (pytest.approx(200e-6), 1),
        ("expand_k7", "b0.c3"): (pytest.approx(150e-6), 1)}
    assert att.lost == 1


def test_nested_scope_paths():
    ev = events() + [X("user_annotation", "inner", 130.0, 10.0),
                     X("cuda_runtime", "cudaLaunchKernel", 135.0, 1.0,
                       corr=9),
                     dev("kernel", "k9", 600.0, 10.0, 9)]
    att = trace.attribute(ev, "cardbench.slice")
    assert ("k9", "b0.c1/inner") in {(o.name, o.scope) for o in att.ops}


def test_busy_union_gaps_and_top_ops():
    ev = events()
    t0, t1, thread = trace.scope_span(ev, "cardbench.slice")
    assert (t0, t1, thread) == (100.0, 1000.0, (1, 7))
    iv = trace.device_intervals(ev, t0, t1)
    assert iv == [(110.0, 500.0)]
    assert trace.busy_us(iv) == 390.0
    g = trace.gaps(ev, iv, t0, t1, thread)
    # 500..1000 idle, its middle (750) outside every op but the slice;
    # 100..110 idle while the host was in the memcpy call
    assert g[0] == ("cardbench.slice", pytest.approx(500e-6))
    assert g[1] == ("cudaMemcpyAsync", pytest.approx(10e-6))
    top = trace.top_ops(ev, t0, t1)
    assert [n for n, _ in top] == ["conv_k2", "expand_k7",
                                   "Memcpy HtoD (Pinned -> Device)"]


def ctx(layers, ev=None):
    """Both slices from the synthetic trace: the device slice is its device
    records but the lead spin, over 900 us of host clock."""
    ev = events() if ev is None else ev
    dev_ev = [e for e in ev
              if e["cat"] in trace.DEVICE_CATS and e["name"] != "spin"]
    return TraceContext(2, 900e-6, dev_ev, trace.device_intervals(dev_ev),
                        2, ev, trace.attribute(ev, "cardbench.slice"),
                        layers, bound_s, 6, 1.95e-3)


def test_readers_on_the_synthetic_slice():
    layers = [Layer("b0.c1", "conv", 10**9, 10**6),
              Layer("b0.c3", "expand", 10**6, 10**8)]
    c = ctx(layers)
    assert reader("device_idle_share").read(c) == pytest.approx(
        100 * (1 - 390 / 900))
    assert reader("h2d_ms_per_batch").read(c) == pytest.approx(0.045)
    assert reader("device_ms_per_batch").read(c) == pytest.approx(0.195)
    # 6 untraced batches at 195 us of device work each, in 1.95 ms
    assert reader("untraced_idle_share").read(c) == pytest.approx(40.0)
    assert reader("mfu_int8").read(c) == pytest.approx(
        100 * 2 * 2 * (10**9 + 10**6) / 900e-6 / 1979e12)
    conv = 2 * max(2e9 / 1979e12, 1e6 / 3.35e12) / 200e-6
    assert reader("conv_roofline").read(c) == pytest.approx(100 * conv)
    assert roofline_share(c, "expand") == pytest.approx(
        100 * 2 * (1e8 / 3.35e12) / 150e-6)
    # nothing of the kind: the reader returns nothing
    assert reader("bsr_conv_roofline").read(c) is None


def test_readers_without_device_records():
    ev = [e for e in events() if e["cat"] not in trace.DEVICE_CATS]
    c = ctx([Layer("b0.c1", "conv", 1, 1)], ev)
    for name in ("device_idle_share", "mfu_int8", "h2d_ms_per_batch",
                 "device_ms_per_batch", "untraced_idle_share",
                 "conv_roofline"):
        assert reader(name).read(c) is None
