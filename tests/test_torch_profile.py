"""PyTorch port: the per-layer profiles.

``runtime/profile.py`` against the JAX package's on the same model (row
names, operations and bytes exactly; only the platform's latencies
differ), the distribution of a measured latency, ``runtime/xprof.py``'s
attribution on synthetic trace events, ``profile_layers`` on the CPU over
the model's ``record_function`` scopes, and the CLI's ``profile``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from resnet_accel_tpu.runtime import profile as jprofile
from resnet_accel_tpu.runtime import xprof as jxprof
from resnet_accel_tpu_torch.models.resnet import (init_resnet_fp32,
                                                  quantize_resnet)
from resnet_accel_tpu_torch.runtime import xprof
from resnet_accel_tpu_torch.runtime.engine import InferenceEngine
from resnet_accel_tpu_torch.runtime.perf import get_platform
from resnet_accel_tpu_torch.runtime.profile import (profile_resnet18,
                                                    profile_table)

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _model(depth, small_input, hw, classes=1000):
    fp32 = init_resnet_fp32(depth, seed=0, num_classes=classes,
                            small_input=small_input)
    calib = np.random.default_rng(0).normal(
        0, 1, (1, 3, hw, hw)).astype(np.float32)
    return quantize_resnet(fp32, calib, depth, classes,
                           small_input=small_input)


@pytest.fixture(scope="module")
def imagenet_models():
    """ResNet-18 and -50 at ImageNet geometry (calibrated at 64 x 64: the
    profile reads only the layers' shapes)."""
    return {d: _model(d, False, 64) for d in (18, 50)}


@pytest.fixture(scope="module")
def cifar18():
    return _model(18, True, 32, classes=10)


class TestRooflineProfile:
    @pytest.mark.parametrize("depth,batch", [(18, 1), (18, 128), (50, 8)])
    def test_rows_equal_jax(self, imagenet_models, depth, batch):
        m = imagenet_models[depth]
        got = profile_resnet18(m, batch=batch).records
        want = jprofile.profile_resnet18(m, batch=batch).records
        assert [r.name for r in got] == [r.name for r in want]
        assert [r.total_ops for r in got] == [r.total_ops for r in want]
        assert [r.bytes_accessed for r in got] == [
            r.bytes_accessed for r in want]
        assert len(got) == (21 if depth == 18 else 54)
        assert all(r.platform == get_platform() for r in got)
        assert got[0].name == "stem" and got[-1].name == "fc"
        if depth == 50:
            assert "b0.c3" in [r.name for r in got]

    def test_roofline_times_on_the_h100(self, imagenet_models):
        p = get_platform()
        for r in profile_resnet18(imagenet_models[18], batch=32).records:
            assert r.latency_s == pytest.approx(max(
                r.total_ops / p.peak_int8_ops,
                r.bytes_accessed / p.hbm_bytes_per_s), rel=1e-12)
            assert r.latency_s == pytest.approx(r.bound_s, rel=1e-12)

    def test_measured_latency_distributes_exactly(self, imagenet_models):
        m = imagenet_models[18]
        pred = profile_resnet18(m, batch=8).records
        prof = profile_resnet18(m, batch=8, measured_latency_s=8e-3)
        total = sum(r.latency_s for r in prof.records)
        assert abs(total - 8e-3) < 1e-12
        scale = 8e-3 / sum(r.latency_s for r in pred)
        for a, b in zip(prof.records, pred):
            assert a.latency_s == pytest.approx(b.latency_s * scale,
                                                rel=1e-12)

    def test_bound_classification_varies(self, imagenet_models):
        bounds = {r.roofline_bound for r in
                  profile_resnet18(imagenet_models[18], batch=32).records}
        assert bounds == {"compute", "memory"}

    def test_small_input_default_hw(self, cifar18):
        got = profile_resnet18(cifar18, batch=2)
        want = jprofile.profile_resnet18(cifar18, batch=2)
        assert [(r.name, r.total_ops, r.bytes_accessed)
                for r in got.records] == [
            (r.name, r.total_ops, r.bytes_accessed) for r in want.records]

    def test_table_renders(self, imagenet_models):
        table = profile_table(profile_resnet18(imagenet_models[18]))
        assert "stem" in table and "TOTAL" in table and "bound" in table
        assert len(table.splitlines()) == 23


def _ev(cat, name, ts, dur, tid=1, pid=100, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": pid, "tid": tid, "args": args}


def _trace():
    """Two threads; scopes a (b0.c1) holding inner (b0.c1/q), then
    b0.c2; launches by runtime and by driver; one kernel with no launch
    in the trace and one launched outside every scope."""
    return [
        {"ph": "M", "name": "process_name", "pid": 100, "tid": 0,
         "args": {"name": "python"}},
        _ev("user_annotation", "b0.c1", 10.0, 50.0),
        _ev("user_annotation", "q", 20.0, 10.0),
        _ev("user_annotation", "b0.c2", 70.0, 30.0),
        _ev("user_annotation", "fc", 10.0, 100.0, tid=2),
        _ev("cpu_op", "aten::add", 12.0, 4.0),
        _ev("cuda_runtime", "cudaLaunchKernel", 13.0, 2.0, correlation=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 22.0, 2.0, correlation=2),
        _ev("cuda_driver", "cuLaunchKernel", 75.0, 2.0, correlation=3),
        _ev("cuda_runtime", "cudaMemcpyAsync", 80.0, 2.0, correlation=4),
        _ev("cuda_runtime", "cudaLaunchKernel", 65.0, 2.0, correlation=5),
        _ev("cuda_runtime", "cudaLaunchKernel", 30.0, 2.0, tid=2,
            correlation=6),
        _ev("cuda_runtime", "cudaStreamSynchronize", 120.0, 5.0,
            correlation=9),
        _ev("kernel", "k_add", 200.0, 4.0, pid=0, tid=7, correlation=1),
        _ev("kernel", "k_q", 205.0, 6.0, pid=0, tid=7, correlation=2),
        _ev("kernel", "k_conv", 212.0, 20.0, pid=0, tid=7, correlation=3),
        _ev("gpu_memcpy", "Memcpy DtoD", 233.0, 1.0, pid=0, tid=7,
            correlation=4),
        _ev("kernel", "k_gap", 235.0, 3.0, pid=0, tid=7, correlation=5),
        _ev("kernel", "k_fc", 240.0, 5.0, pid=0, tid=7, correlation=6),
        _ev("kernel", "k_lost", 246.0, 7.0, pid=0, tid=7, correlation=8),
        _ev("kernel", "k_add", 254.0, 4.0, pid=0, tid=7, correlation=1),
        _ev("gpu_user_annotation", "b0.c1", 200.0, 11.0, pid=0, tid=7),
        {"ph": "f", "cat": "ac2g", "name": "flow", "pid": 0, "tid": 7,
         "ts": 200.0, "id": 1},
    ]


class TestAttribution:
    def test_device_time_by_innermost_scope(self):
        ops = xprof.attribute(_trace(), device=True)
        by = {(o.instr, o.scope): (o.duration_s, o.count) for o in ops}
        assert by[("k_add", "b0.c1")] == (pytest.approx(8e-6), 2)
        assert by[("k_q", "b0.c1/q")] == (pytest.approx(6e-6), 1)
        assert by[("k_conv", "b0.c2")][1] == 1            # driver launch
        assert ("Memcpy DtoD", "b0.c2") in by
        assert by[("k_gap", "")][1] == 1                  # outside scopes
        assert by[("k_fc", "fc")][1] == 1                 # other thread
        assert by[("k_lost", "")][1] == 1                 # no launch
        assert "b0.c1" not in {o.instr for o in ops}      # not the spans
        agg = xprof.by_scope(ops)
        assert agg == {
            "b0.c1": pytest.approx(14e-6), "b0.c2": pytest.approx(21e-6),
            "fc": pytest.approx(5e-6),
            xprof.UNATTRIBUTED: pytest.approx(10e-6)}
        assert sum(agg.values()) == pytest.approx(50e-6)
        deep = xprof.by_scope(ops, depth=2)
        assert deep["b0.c1/q"] == pytest.approx(6e-6)
        assert deep["b0.c1"] == pytest.approx(8e-6)

    def test_cpu_self_time(self):
        ops = xprof.attribute(_trace(), device=False)
        agg = xprof.by_scope(ops, depth=2)
        assert agg == {"b0.c1": pytest.approx(40e-6),
                       "b0.c1/q": pytest.approx(10e-6),
                       "b0.c2": pytest.approx(30e-6),
                       "fc": pytest.approx(100e-6)}
        assert xprof.by_scope(ops)["b0.c1"] == pytest.approx(50e-6)

    def test_root_keeps_the_traced_call_only(self):
        """A lead kernel launched before the call's scope is not the
        call's; inside it, paths are taken relative to the call."""
        evs = [_ev("user_annotation", "call", 100.0, 50.0),
               _ev("user_annotation", "b0.c1", 110.0, 10.0),
               _ev("cuda_runtime", "cudaLaunchKernel", 5.0, 1.0,
                   correlation=1),
               _ev("cuda_runtime", "cudaLaunchKernel", 112.0, 1.0,
                   correlation=2),
               _ev("cuda_runtime", "cudaLaunchKernel", 130.0, 1.0,
                   correlation=3),
               _ev("kernel", "lead", 150.0, 5000.0, pid=0, correlation=1),
               _ev("kernel", "conv", 5200.0, 40.0, pid=0, correlation=2),
               _ev("kernel", "tail", 5250.0, 3.0, pid=0, correlation=3),
               _ev("kernel", "orphan", 5260.0, 2.0, pid=0, correlation=7)]
        ops = xprof.attribute(evs, device=True, root="call")
        assert xprof.by_scope(ops) == {
            "b0.c1": pytest.approx(40e-6),
            xprof.UNATTRIBUTED: pytest.approx(5e-6)}
        cpu = xprof.by_scope(xprof.attribute(evs, device=False, root="call"))
        assert cpu == {"b0.c1": pytest.approx(10e-6)}

    def test_a_lost_kernel_raises(self):
        """A launch inside the call whose kernel the trace dropped fails
        the attribution instead of shrinking its scope."""
        evs = [_ev("user_annotation", "call", 100.0, 50.0),
               _ev("user_annotation", "stem", 101.0, 10.0),
               _ev("cuda_runtime", "cudaLaunchKernel", 102.0, 1.0,
                   correlation=1),
               _ev("cuda_runtime", "cudaLaunchKernelExC", 120.0, 1.0,
                   correlation=2),
               _ev("cuda_runtime", "cudaFuncSetAttribute", 119.0, 1.0,
                   correlation=3),
               _ev("kernel", "k", 300.0, 2.0, pid=0, correlation=2)]
        with pytest.raises(RuntimeError, match="1 launches"):
            xprof.attribute(evs, device=True, root="call")
        kept = [e for e in evs if e["args"].get("correlation") != 1]
        assert xprof.by_scope(xprof.attribute(kept, device=True,
                                              root="call")) == {
            xprof.UNATTRIBUTED: pytest.approx(2e-6)}

    def test_no_device_work_raises(self):
        cpu_only = [e for e in _trace() if e.get("pid") != 0]
        with pytest.raises(RuntimeError, match="no device kernel"):
            xprof.attribute(cpu_only, device=True)

    def test_same_start_nests_outer_first(self):
        evs = [_ev("user_annotation", "inner", 10.0, 5.0),
               _ev("user_annotation", "outer", 10.0, 20.0),
               _ev("cuda_runtime", "cudaLaunchKernel", 11.0, 1.0,
                   correlation=1),
               _ev("cuda_runtime", "cudaLaunchKernel", 20.0, 1.0,
                   correlation=2),
               _ev("kernel", "a", 50.0, 2.0, pid=0, correlation=1),
               _ev("kernel", "b", 53.0, 3.0, pid=0, correlation=2)]
        agg = xprof.by_scope(xprof.attribute(evs, device=True), depth=3)
        assert agg == {"outer/inner": pytest.approx(2e-6),
                       "outer": pytest.approx(3e-6)}

    def test_layer_table_matches_jax_and_adds_bounds(self):
        agg = {"b0.c1": 3e-5, "stem": 1e-4, "pool": 1e-6}
        assert xprof.layer_table(agg) == jxprof.layer_table(agg)
        t = xprof.layer_table(agg, {"stem": 2e-5, "b0.c1": 1e-5})
        lines = t.splitlines()
        assert "bound us" in lines[0]
        assert lines[1].split()[0] == "stem" and lines[1].split()[-1] == "20.0"
        assert lines[3].split()[0] == "pool" and lines[3].split()[-1] == "-"
        assert lines[-1].split()[-1] == "30.0"


class TestProfileLayers:
    def test_cpu_rows_are_the_profile_rows_and_pool(self, cifar18):
        eng = InferenceEngine(cifar18, device="cpu")
        x = torch.from_numpy(np.random.default_rng(1).normal(
            0, 1, (2, 3, 32, 32)).astype(np.float32))
        agg, ops = xprof.profile_layers(eng.module, x)
        rows = [r.name for r in profile_resnet18(cifar18, batch=2).records]
        assert set(agg) == set(rows) | {"pool"}
        assert all(v > 0 for v in agg.values())
        assert all(o.scope for o in ops)

    def test_scopes_cost_nothing_unprofiled(self, cifar18):
        from resnet_accel_tpu_torch.models import resnet18 as P
        assert not torch.autograd._profiler_enabled()
        assert not isinstance(P._scope("stem"),
                              torch.profiler.record_function)

    def test_bottleneck_scopes(self):
        m = _model(50, True, 32, classes=10)
        eng = InferenceEngine(m, device="cpu")
        x = torch.from_numpy(np.random.default_rng(2).normal(
            0, 1, (1, 3, 32, 32)).astype(np.float32))
        events, cuda = xprof.capture(eng.module, x)
        assert not cuda
        agg = xprof.by_scope(xprof.attribute(events, device=False,
                                             root=xprof.CALL_SCOPE))
        assert {k.split("/")[0] for k in xprof.by_scope(
            xprof.attribute(events, device=False))} == {xprof.CALL_SCOPE}
        rows = [r.name for r in profile_resnet18(m, batch=1).records]
        assert set(agg) == set(rows) | {"pool"}
        assert "b15.c3" in agg and "b0.ds" in agg

    def test_trace_kept_in_logdir(self, cifar18, tmp_path):
        eng = InferenceEngine(cifar18, device="cpu")
        x = torch.zeros((1, 3, 32, 32))
        xprof.profile_layers(eng.module, x, logdir=str(tmp_path))
        assert (tmp_path / "xprof_trace.json").stat().st_size > 0


@pytest.mark.parametrize("extra", [[], ["--measured"],
                                   ["--measured", "--depth", "34"]])
def test_cli_profile_cpu(extra):
    proc = subprocess.run(
        [sys.executable, "-m", "resnet_accel_tpu_torch", "profile",
         "--small-input", "--batch", "2", "--device", "cpu", *extra],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert any(ln.split()[:1] == ["TOTAL"] for ln in lines)
    names = {ln.split()[0] for ln in lines if ln.strip()}
    assert {"stem", "b0.c1", "fc"} <= names
    if extra:
        assert "bound us" in proc.stdout and "pool" in names
    else:
        assert "util%" in proc.stdout
    assert "host time on cpu" in proc.stdout
