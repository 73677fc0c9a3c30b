"""The readers of the program's own spans and of its launches, on a
synthetic Chrome trace of a host slice with a known answer, and on one
without the spans, where they find nothing to read."""

import pytest

from cardbench import spans, trace
from cardbench.context import TraceContext
from cardbench.harness import reader
from cardbench.work.resnet_int8 import Layer, bound_s

HOST = dict(pid=1, tid=7)
SPAN_READERS = ("fill_ms_per_batch", "idle_in_fill_share",
                "idle_in_drain_share", "bsr_im2col_ms_per_batch",
                "bsr_k4_ms_per_batch", "bsr_join_ms_per_batch")


def X(cat, name, ts, dur, corr=None, **where):
    e = dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, **(where or HOST))
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def scope(name, ts, dur):
    return X("user_annotation", name, ts, dur)


def dev(cat, name, ts, dur, corr):
    return X(cat, name, ts, dur, corr, pid=0, tid=3)


def events(program_spans=True):
    """A slice of 1000 us: a fill that waits 30 us on the ring, a sparse
    layer (im2col, k4, join), a fill with no wait, the fc, the drain.
    The card runs 130-330 (im2col's 50 us, then k4's 150), 450-470 (the
    join) and 600-650 (the drain's copy): idle 730 us of the window."""
    ev = [scope("cardbench.slice", 0.0, 1000.0),
          scope("b0.c1", 100.0, 200.0),
          scope("fc", 400.0, 100.0),
          X("cuda_runtime", "cudaLaunchKernel", 120.0, 5.0, corr=1),
          X("cuda_runtime", "cudaLaunchKernel", 160.0, 5.0, corr=2),
          # the driver's record of the same launch, inside the runtime's
          X("cuda_driver", "cuLaunchKernel", 161.0, 2.0, corr=12),
          X("cuda_runtime", "cudaLaunchKernel", 260.0, 5.0, corr=3),
          X("cuda_runtime", "cudaMemcpyAsync", 510.0, 5.0, corr=4),
          # before the slice, and on another thread: not the slice's
          X("cuda_runtime", "cudaLaunchKernel", -50.0, 5.0, corr=5),
          X("cuda_runtime", "cudaLaunchKernel", 200.0, 5.0, corr=6,
            pid=1, tid=8),
          dev("kernel", "im2col_copy", 130.0, 50.0, 1),
          dev("kernel", "bsr_small_kernel", 180.0, 150.0, 2),
          dev("kernel", "join_add", 450.0, 20.0, 3),
          dev("gpu_memcpy", "Memcpy DtoH", 600.0, 50.0, 4),
          dev("kernel", "spin", -40.0, 20.0, 5)]
    if program_spans:
        ev += [scope("engine.fill", 10.0, 90.0),
               scope("engine.ring_wait", 20.0, 30.0),
               scope("im2col", 110.0, 40.0),
               scope("k4", 150.0, 100.0),
               scope("join", 250.0, 40.0),
               scope("engine.fill", 300.0, 100.0),
               scope("engine.drain", 500.0, 400.0)]
    return ev


def ctx(ev):
    layers = [Layer("b0.c1", "bsr", 10**6, 10**6),
              Layer("fc", "fc", 10**3, 10**3)]
    dev_ev = [e for e in ev if e["cat"] in trace.DEVICE_CATS]
    return TraceContext(2, 1000e-6, dev_ev, trace.device_intervals(dev_ev),
                        2, ev, trace.attribute(ev, "cardbench.slice"),
                        layers, bound_s)


def test_span_paths_and_idle():
    c = ctx(events())
    assert spans.window(c) == (0.0, 1000.0, (1, 7))
    assert spans.spans(c, ["engine.fill"]) == [(10.0, 100.0),
                                               (300.0, 400.0)]
    assert spans.spans(c, ["engine.fill/engine.ring_wait"]) == [
        (20.0, 50.0)]
    assert spans.spans(c, ["engine.ring_wait"]) == []   # not at the top
    assert spans.idle(c) == [(0.0, 130.0), (330.0, 450.0), (470.0, 600.0),
                             (650.0, 1000.0)]
    assert spans.overlap_us([(0.0, 10.0), (20.0, 30.0)],
                            [(5.0, 25.0)]) == 10.0


def test_readers_on_the_synthetic_slice():
    c = ctx(events())
    # fills 90 + 100 us less the 30 us wait, over 2 batches
    assert reader("fill_ms_per_batch").read(c) == pytest.approx(0.080)
    # idle inside the fills: 10-100 and 330-400
    assert reader("idle_in_fill_share").read(c) == pytest.approx(16.0)
    # inside the drain: 500-600 and 650-900
    assert reader("idle_in_drain_share").read(c) == pytest.approx(35.0)
    # inside b0.c1 (100-130) and fc (400-450, 470-500)
    assert reader("idle_in_forward_share").read(c) == pytest.approx(11.0)
    # three launches in the slice on its thread, the nested driver record
    # counted once, the memcpy not a launch
    assert reader("launches_per_batch").read(c) == pytest.approx(1.5)
    assert reader("bsr_im2col_ms_per_batch").read(c) == pytest.approx(0.025)
    assert reader("bsr_k4_ms_per_batch").read(c) == pytest.approx(0.075)
    assert reader("bsr_join_ms_per_batch").read(c) == pytest.approx(0.010)


def test_idle_shares_sum_to_at_most_the_slice_idle():
    c = ctx(events())
    parts = sum(reader(n).read(c) for n in (
        "idle_in_fill_share", "idle_in_drain_share",
        "idle_in_forward_share"))
    t0, t1, _ = spans.window(c)
    assert parts <= 100.0 * trace.busy_us(spans.idle(c)) / (t1 - t0)


def test_bsr_splits_sum_to_the_layer_scope():
    c = ctx(events())
    split = sum(reader(f"bsr_{s}_ms_per_batch").read(c)
                for s in ("im2col", "k4", "join"))
    assert split == pytest.approx(
        1e3 * c.scope_seconds()["b0.c1"] / c.host_batches)


@pytest.mark.parametrize("name", SPAN_READERS)
def test_readers_without_the_spans_read_nothing(name):
    """A program older than the spans gives nothing to read, and the
    reader does not raise."""
    assert reader(name).read(ctx(events(program_spans=False))) is None


def test_forward_and_launches_read_without_the_engine_spans():
    c = ctx(events(program_spans=False))
    assert reader("idle_in_forward_share").read(c) == pytest.approx(11.0)
    assert reader("launches_per_batch").read(c) == pytest.approx(1.5)


def test_no_launch_reads_nothing():
    ev = [e for e in events() if e["cat"] not in trace.LAUNCH_CATS]
    assert reader("launches_per_batch").read(ctx(ev)) is None
