"""PyTorch port: the spans the serving path opens while a profiler records.

``InferenceEngine.stream`` opens ``engine.fill`` for each batch's fill of
its staging ring (``engine.ring_wait`` inside it where the ring waits on
an event) and ``engine.drain`` for each call's end, never around a layer's
scope; a block-sparse layer's scope holds ``k4`` alone where its blocks
are at most 16 x 16 (K4's conv route, one launch), else ``im2col``,
``k4`` and, where it joins a residual, ``join``; the layer keys of
``xprof.by_scope`` stay the profile's rows and ``pool``.  All on the CPU,
over a small CIFAR ResNet-18 block-pruned at 64 x 64, its BSR attached at
64 x 64 and at 14 x 14.
"""

import json

import numpy as np
import pytest
import torch

from resnet_accel_tpu_torch.models import resnet18 as P
from resnet_accel_tpu_torch.models.resnet import (init_resnet_fp32,
                                                  quantize_resnet)
from resnet_accel_tpu_torch.runtime import xprof
from resnet_accel_tpu_torch.runtime.engine import (InferenceEngine,
                                                   QuantizingLoader,
                                                   _StagingRing)
from resnet_accel_tpu_torch.runtime.profile import profile_resnet18

torch.set_num_threads(2)
BATCH, N_BATCHES, CALLS = 2, 3, 2


def _models():
    fp32 = P.prune_params_blockwise(
        init_resnet_fp32(18, seed=0, num_classes=10, small_input=True),
        sparsity=0.7, block=64)
    calib = np.random.default_rng(0).normal(
        0, 1, (1, 3, 32, 32)).astype(np.float32)
    dense = quantize_resnet(fp32, calib, 18, 10, small_input=True)
    return {"dense": dense, "sparse": P.attach_bsr(dense, block=64),
            "sparse14": P.attach_bsr(dense, block=14)}


@pytest.fixture(scope="module")
def models():
    return _models()


def _images(n):
    return np.random.default_rng(1).normal(
        0, 1, (n, 3, 32, 32)).astype(np.float32)


def _paths(fn, tmp):
    """The ``record_function`` scope paths of one profiled ``fn()``, by
    host thread, in order of their start."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = str(tmp / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [p for _, rows in xprof._Scopes(events).threads.values()
            for _, _, p in rows]


@pytest.fixture(scope="module")
def paths_of(models, tmp_path_factory):
    """The scope paths of ``CALLS`` streams of the model ``kind``, each
    profiled once."""
    cache = {}

    def get(kind):
        if kind not in cache:
            model = models[kind]
            eng = InferenceEngine(model, device="cpu")
            loader = QuantizingLoader(_images(BATCH * N_BATCHES),
                                      model.s_input, BATCH)

            def serve():
                for _ in range(CALLS):
                    eng.stream(loader, N_BATCHES)
            cache[kind] = _paths(serve, tmp_path_factory.mktemp("stream"))
        return cache[kind]
    return get


@pytest.fixture(scope="module")
def stream_paths(paths_of):
    return paths_of("sparse")


def _layer_scopes(model):
    rows = [r.name for r in profile_resnet18(model, batch=1).records]
    return set(rows) | {"pool"}


def test_one_fill_a_batch_and_one_drain_a_call(stream_paths):
    assert stream_paths.count("engine.fill") == CALLS * N_BATCHES
    assert stream_paths.count("engine.drain") == CALLS
    # the CPU ring records no event, so nothing is waited on
    assert not any("engine.ring_wait" in p for p in stream_paths)


def test_no_engine_span_encloses_a_layer_scope(models, stream_paths):
    layers = _layer_scopes(models["sparse"])
    for p in stream_paths:
        parts = p.split("/")
        assert not (set(parts[1:]) & layers), p
        if any(x.startswith("engine.") for x in parts):
            assert p in ("engine.fill", "engine.drain",
                         "engine.fill/engine.ring_wait"), p
    assert {p for p in stream_paths if "/" not in p} == layers | {
        "engine.fill", "engine.drain"}


@pytest.mark.parametrize("kind", ["sparse", "sparse14"])
def test_bsr_layer_scopes_hold_im2col_k4_and_join(models, paths_of, kind):
    model = models[kind]
    sparse = set(model.sparsity_report())
    assert sparse and "stem" not in sparse
    small = {qc.bsr.block_h for _, qc in model.named_convs()
             if qc.bsr is not None} == {14}
    assert small == (kind == "sparse14")
    stream_paths = paths_of(kind)
    inner = {}
    for p in stream_paths:
        head, _, leaf = p.partition("/")
        if leaf:
            inner.setdefault(head, set()).add(leaf)
    assert set(inner) == sparse
    for name, leaves in inner.items():
        # K4's conv route joins in its one launch; on the chain a basic
        # block's c2 joins the residual, c1 and ds do not
        want = {"k4"} if small else {"im2col", "k4"} | (
            {"join"} if name.endswith(".c2") else set())
        assert leaves == want, name
    n_forwards = CALLS * N_BATCHES
    assert stream_paths.count("b0.c1/k4") == n_forwards


def test_run_inference_opens_no_engine_span(models, tmp_path):
    # the engine's spans are the int8 stream's alone: the fp32 ring of
    # run_inference is another fill and keeps out of engine.fill
    eng = InferenceEngine(models["sparse"], device="cpu")
    paths = _paths(lambda: eng.run_inference(_images(BATCH)), tmp_path)
    assert "b0.c1" in paths
    assert not any("engine." in p for p in paths), paths


def test_ring_wait_only_on_an_event_and_inside_the_fill(tmp_path):
    class Event:
        waits = 0

        def synchronize(self):
            Event.waits += 1

    ring = _StagingRing(torch.device("cpu"), torch.int8, depth=2)
    ring.events[0] = Event()
    x = np.zeros((BATCH, 3, 32, 32), np.int8)

    class Loader:
        def next(self):
            return x, None

    def fill_twice():
        for _ in range(2):
            InferenceEngine._fill(Loader(), ring)
            ring.upload()
    paths = _paths(fill_twice, tmp_path)
    assert Event.waits == 1
    assert paths.count("engine.fill") == 2
    assert paths.count("engine.fill/engine.ring_wait") == 1
    assert [p for p in paths if "ring_wait" in p] == [
        "engine.fill/engine.ring_wait"]


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_by_scope_keys_are_the_layer_rows(models, kind):
    model = models[kind]
    eng = InferenceEngine(model, device="cpu")
    agg, ops = xprof.profile_layers(eng.module,
                                    torch.from_numpy(_images(BATCH)))
    assert set(agg) == _layer_scopes(model)
    deep = {o.scope for o in ops if "/" in o.scope}
    if kind == "dense":
        assert not deep
    else:
        assert {s.split("/")[1] for s in deep} == {"im2col", "k4", "join"}
