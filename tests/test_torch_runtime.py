"""PyTorch port: the serving runtime against the JAX package's.

``runtime/perf.py`` (``PerfMetrics``, ``LayerProfiler``, ``PerfTimer``,
the platform row, ``median_pair_time`` and ``measure_chained`` on a
scripted clock), ``runtime/power.py`` (the report's arithmetic with the
watts given, the telemetry probe, live sampling through a stand-in
``nvidia-smi``), and ``InferenceEngine``: its typed errors on the same
misuse as the JAX engine, ``verify_accuracy`` equal to JAX's, and
``stream`` over the native ``BatchLoader`` equal to JAX ``run_inference``
on the same preprocessed images with tolerance 0 (the tolerance of
``tests/test_torch_resnet18.py``: the same quantized model, carried
across by ``from_reference``, gives the same bits).
"""

import os
import shutil
import stat
from unittest import mock

import numpy as np
import pytest
import torch

from resnet_accel_tpu.models import resnet18 as J
from resnet_accel_tpu.runtime import engine as jengine
from resnet_accel_tpu.runtime import perf as jperf
from resnet_accel_tpu.runtime import power as jpower
from resnet_accel_tpu_torch import native
from resnet_accel_tpu_torch.models import resnet18 as P
from resnet_accel_tpu_torch.runtime import perf, power
from resnet_accel_tpu_torch.runtime.engine import (IMAGENET_MEAN,
                                                   IMAGENET_STD,
                                                   AccelErrorCode,
                                                   AcceleratorError,
                                                   InferenceEngine,
                                                   QuantizingLoader,
                                                   preprocess_imagenet)

torch.set_num_threads(2)

STAGES = [(64, 1, 1), (128, 1, 2)]


@pytest.fixture(scope="module")
def models():
    """A JAX-quantized small ResNet-18 (CIFAR stem, two stages, 10
    classes), its JAX engine on the CPU and the port's engine on the same
    model."""
    params = J.init_resnet18_fp32(seed=0, num_classes=10, small_input=True,
                                  stages=STAGES)
    calib = np.random.default_rng(1).normal(
        0, 1, (4, 3, 32, 32)).astype(np.float32)
    ref = J.quantize_resnet18(params, calib, 10, small_input=True,
                              stages=STAGES)
    port = P.from_reference(ref)
    return dict(ref=ref, port=port,
                jeng=jengine.InferenceEngine(ref, J.make_forward,
                                             backend="cpu"),
                eng=InferenceEngine(port, device="cpu"))


def _images(n, seed=2):
    return np.random.default_rng(seed).integers(
        0, 256, (n, 32, 32, 3)).astype(np.uint8)


class TestPerf:
    def test_metrics_fields_equal_jax(self):
        for ops, nbytes in ((2 * 10**9, 10**6), (10**6, 10**8)):
            m = perf.PerfMetrics("x", 1e-3, ops, nbytes)
            j = jperf.PerfMetrics("x", 1e-3, ops, nbytes)
            assert m.gops == j.gops and m.bandwidth_gbs == j.bandwidth_gbs
            assert m.operational_intensity == j.operational_intensity
            assert m.utilization == ops / 1e-3 / 1979e12
        m = perf.PerfMetrics("x", 1e-3, 2 * 10**9, 10**6)
        assert m.roofline_bound == "compute" and "GOPS" in m.report()
        assert perf.PerfMetrics("y", 1e-3, 10**6, 10**8).roofline_bound \
            == "memory"
        assert perf.PerfMetrics("z", 0.0, 1, 1).gops == 0.0

    def test_platform_is_the_h100_only(self, monkeypatch):
        p = perf.get_platform()
        assert set(perf.PLATFORMS) == {"h100"} and p.name == "h100"
        assert (p.peak_int8_ops, p.peak_bf16_flops, p.hbm_bytes_per_s,
                p.hbm_bytes) == (1979e12, 989e12, 3.35e12, 80e9)
        assert perf.get_platform("H100") is p
        monkeypatch.setenv("RESNET_ACCEL_TPU_PLATFORM", "v5p")
        assert perf.get_platform() is p
        with pytest.raises(ValueError, match="unknown platform"):
            perf.get_platform("v5e")

    def test_layer_profiler_equal_jax(self):
        rows = [("a", 1e-4, 10**9, 10**6), ("b", 3e-4, 4 * 10**9, 10**7)]
        lp, jlp = perf.LayerProfiler(), jperf.LayerProfiler()
        for r in rows:
            lp.add(perf.PerfMetrics(*r))
            jlp.add(jperf.PerfMetrics(*r))
        assert lp.summary() == jlp.summary()
        assert lp.report().splitlines()[-1] == jlp.report().splitlines()[-1]
        assert len(lp.report().splitlines()) == 3

    def test_perf_timer_cpu(self):
        m = perf.PerfTimer(warmup=1, iters=3).measure(
            "add", lambda a: a + 1, torch.zeros(64, 64), total_ops=4096)
        assert m.latency_s > 0 and m.iters == 3 and m.total_ops == 4096

    def test_median_pair_time_scripted_clock(self):
        # each timing reads the clock twice; t1 = 1 ms, t_chain = 9 ms
        ticks = iter(base + off for base in range(1000)
                     for off in (0.0, 0.001, 0.002, 0.011))
        with mock.patch.object(perf.time, "perf_counter",
                               side_effect=lambda: next(ticks)):
            dt = perf.median_pair_time(lambda x: x, lambda x: x, None,
                                       chain=9, iters=3)
        assert abs(dt - 0.001) < 1e-12

    def test_median_pair_time_validation_and_fallback(self):
        with pytest.raises(ValueError, match="chain"):
            perf.median_pair_time(lambda x: x, lambda x: x, None, chain=1)
        # chained run faster than the single one: strict raises, default
        # falls back to the raw chained time
        ticks = iter(base + off for base in range(1000)
                     for off in (0.0, 0.005, 0.006, 0.007))
        with mock.patch.object(perf.time, "perf_counter",
                               side_effect=lambda: next(ticks)):
            with pytest.raises(RuntimeError, match="non-positive"):
                perf.median_pair_time(lambda x: x, lambda x: x, None,
                                      chain=16, iters=3, strict=True)
            dt = perf.median_pair_time(lambda x: x, lambda x: x, None,
                                       chain=16, iters=3)
        assert dt == pytest.approx(0.001 / 16)

    def test_median_pair_time_real_cpu(self):
        x = torch.randn(64, 64)

        def chain(k):
            def run(a):
                for _ in range(k):
                    a = torch.tanh(a @ a)
                return a
            return run
        assert perf.median_pair_time(chain(1), chain(8), x, chain=8,
                                     iters=3) > 0

    def test_measure_chained_scripted_clock(self):
        """Each call costs 1 ms and each reading of the clock 10 ms: the
        difference of chained and single passes leaves the call."""
        clock = [0.0]

        def read():
            clock[0] += 0.010
            return clock[0]

        def fn(a):
            clock[0] += 0.001
            return a + 1

        with mock.patch.object(perf.time, "perf_counter", side_effect=read):
            dt = perf.measure_chained(fn, np.zeros(2), lambda a, o: o,
                                      outer=5, chain=16, reps=2)
        assert dt == pytest.approx(0.001, rel=1e-9)

    def test_measure_chained_feeds_back(self):
        seen = []

        def fn(a):
            seen.append(float(a[0]))
            return a * 2
        perf.measure_chained(fn, torch.ones(2), lambda a, o: o - a,
                             outer=1, chain=2, reps=1)
        assert seen[:3] == [1.0, 1.0, 1.0]          # warm-up, then a chain


class TestPower:
    def test_profile_math_with_explicit_watts(self):
        p = power.estimate_power("fc1", duration_s=0.5, total_ops=10**11,
                                 utilization=0.5, tdp_w=700.0, idle_w=70.0)
        j = jpower.estimate_power("fc1", duration_s=0.5, total_ops=10**11,
                                  utilization=0.5, tdp_w=700.0, idle_w=70.0)
        assert p.modeled and p.avg_w == j.avg_w == 70.0 + 0.5 * 630.0
        assert p.peak_w == 700.0
        assert p.energy_j == pytest.approx(p.avg_w * 0.5)
        assert p.energy_mj == pytest.approx(p.energy_j * 1e3)
        assert p.gops_per_w == pytest.approx(j.gops_per_w)
        assert p.report() == j.report() and "(modeled)" in p.report()
        live = power.PowerProfile("x", 1.0, 100.0, 120.0, modeled=False)
        assert "(modeled)" not in live.report()
        assert power.PowerProfile("z", 0.0, 0.0, 0.0).gops_per_w == 0.0

    def test_estimate_needs_the_watts(self):
        with pytest.raises(TypeError):
            power.estimate_power("x", 1.0, 0, 0.5)
        p = power.estimate_power("idle", 1.0, 0, utilization=-3.0,
                                 tdp_w=700.0, idle_w=60.0)
        assert p.avg_w == 60.0 and p.peak_w == 60.0

    def test_probe_reports_every_source(self):
        status = power.probe_live_telemetry()
        assert set(status) == {"nvidia_smi", "hwmon_rails",
                               "torch_cuda_memory_stats"}
        if shutil.which("nvidia-smi") is None:      # this CPU host
            assert status == {"nvidia_smi": "none", "hwmon_rails": "none",
                              "torch_cuda_memory_stats": "none"}
            with pytest.raises(RuntimeError, match="nvidia-smi"):
                power.PowerSampler()


FAKE_SMI = """#!{python}
import sys
q = [a for a in sys.argv if a.startswith("--query-gpu=")][0]
vals = {{"power.draw.instant": "{instant}", "power.draw": "123.5",
        "power.limit": "700.00", "clocks.sm": "1980"}}
fields = q.split("=", 1)[1].split(",")
if any(f not in vals for f in fields):
    print("Field is not a valid field to query.")
    sys.exit(2)
print(", ".join(vals[f] for f in fields))
"""


@pytest.mark.parametrize("instant,field,watts", [
    ("301.25", "power.draw.instant", 301.25),
    ("[N/A]", "power.draw", 123.5)])
def test_live_sampling_through_nvidia_smi(tmp_path, monkeypatch, instant,
                                          field, watts):
    import sys
    exe = tmp_path / "nvidia-smi"
    exe.write_text(FAKE_SMI.format(python=sys.executable, instant=instant))
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}{os.environ['PATH']}")
    status = power.probe_live_telemetry()
    assert status["nvidia_smi"]["field"] == field
    assert status["nvidia_smi"]["power_limit_w"] == 700.0
    assert status["nvidia_smi"]["idle_w"] == watts
    with power.PowerSampler() as ps:
        import time
        time.sleep(0.3)
    assert ps.field == field and ps.watts and ps.duration_s >= 0.3
    prof = ps.profile("region", total_ops=10**12)
    assert not prof.modeled
    assert prof.avg_w == prof.peak_w == watts
    assert ps.avg_sm_mhz == 1980.0
    assert prof.gops_per_w == pytest.approx(
        1e3 / ps.duration_s / watts)


class TestEngineErrors:
    def test_non_4d_input_as_jax(self, models):
        x = np.zeros((3, 32, 32), np.float32)
        with pytest.raises(jengine.AcceleratorError) as je:
            models["jeng"].run_inference(x)
        for call in (models["eng"].run_inference, models["eng"].benchmark,
                     models["eng"].verify_accuracy):
            args = (x, [0]) if call == models["eng"].verify_accuracy else (x,)
            with pytest.raises(AcceleratorError) as pe:
                call(*args)
            assert pe.value.code.value == je.value.code.value \
                == "invalid_config"
            assert pe.value.code == AccelErrorCode.INVALID_CONFIG

    def test_zero_batches_as_jax(self, models):
        x = preprocess_imagenet(_images(4))
        s = models["port"].s_input
        with pytest.raises(jengine.AcceleratorError) as je:
            models["jeng"].stream(QuantizingLoader(x, s, 2), 0)
        with pytest.raises(AcceleratorError) as pe:
            models["eng"].stream(QuantizingLoader(x, s, 2), 0)
        assert pe.value.code.value == je.value.code.value == "invalid_config"

    def test_timeout_as_jax(self, models):
        x = preprocess_imagenet(_images(2))
        jeng = jengine.InferenceEngine(models["ref"], J.make_forward,
                                       backend="cpu", timeout_s=0)
        with pytest.raises(jengine.AcceleratorError) as je:
            jeng.run_inference(x)
        eng = InferenceEngine(models["port"], device="cpu", timeout_s=0)
        with pytest.raises(AcceleratorError, match="timeout") as pe:
            eng.run_inference(x)
        assert pe.value.code.value == je.value.code.value == "timeout"
        assert isinstance(pe.value, RuntimeError)

    def test_failure_at_the_synchronize(self, models):
        class Failing:
            def cpu(self):
                raise RuntimeError("CUDA error: an illegal memory access")
        eng = InferenceEngine(models["port"], device="cpu")
        eng.module = lambda x: Failing()
        with pytest.raises(AcceleratorError, match="illegal") as e:
            eng.run_inference(np.zeros((1, 3, 32, 32), np.float32))
        assert e.value.code == AccelErrorCode.BACKEND_UNAVAILABLE
        assert isinstance(e.value.__cause__, RuntimeError)

    def test_error_codes_equal_jax(self):
        assert [(c.name, c.value) for c in AccelErrorCode] == [
            (c.name, c.value) for c in jengine.AccelErrorCode]
        e = AcceleratorError(AccelErrorCode.TIMEOUT, "slow")
        assert str(e) == str(jengine.AcceleratorError(
            jengine.AccelErrorCode.TIMEOUT, "slow"))


class TestEngineServing:
    def test_verify_accuracy_equals_jax(self, models):
        x = preprocess_imagenet(_images(8, seed=3))
        pred = models["jeng"].run_inference(x).predictions
        labels = np.where(np.arange(8) % 3 == 0, (pred + 1) % 10, pred)
        got = models["eng"].verify_accuracy(x, labels)
        assert got == models["jeng"].verify_accuracy(x, labels)
        assert got == pytest.approx(5 / 8)

    def test_native_stream_equals_jax_run_inference(self, models):
        """Tolerance 0: the native loader's int8 batches through the
        port's stream give JAX run_inference's logits on the same images
        preprocessed in fp32."""
        u8 = _images(12, seed=4)
        labels = np.arange(12, dtype=np.int32) % 10
        chw = np.ascontiguousarray(u8.transpose(0, 3, 1, 2))
        with native.BatchLoader(chw, labels, 4, IMAGENET_MEAN, IMAGENET_STD,
                                models["port"].s_input, shuffle=False,
                                n_threads=3, depth=2) as ld:
            res = models["eng"].stream(ld, 3)
        want = models["jeng"].run_inference(preprocess_imagenet(u8))
        np.testing.assert_array_equal(res.logits, want.logits)
        np.testing.assert_array_equal(res.predictions, want.predictions)
        np.testing.assert_array_equal(res.labels, labels)
        assert res.images_per_s > 0 and 0.0 <= res.accuracy <= 1.0

    def test_native_and_quantizing_loader_streams_agree(self, models):
        u8 = _images(8, seed=5)
        chw = np.ascontiguousarray(u8.transpose(0, 3, 1, 2))
        s = models["port"].s_input
        eng = models["eng"]
        with native.BatchLoader(chw, None, 4, IMAGENET_MEAN, IMAGENET_STD,
                                s, shuffle=False, n_threads=2) as ld:
            a = eng.stream(ld, 2)
            one = eng.stream(ld, 1)                  # the stream goes on
        b = eng.stream(QuantizingLoader(preprocess_imagenet(u8), s, 4), 2)
        np.testing.assert_array_equal(a.logits, b.logits)
        assert a.labels is None and b.labels is None
        np.testing.assert_array_equal(one.logits, a.logits[:4])

    def test_stream_refuses_a_loader_of_other_items(self, models):
        with native.BatchLoader(np.zeros((4, 3, 8), np.uint8), None, 2,
                                IMAGENET_MEAN, IMAGENET_STD, 0.02) as ld:
            with pytest.raises(ValueError, match="NCHW"):
                models["eng"].stream(ld, 1)

    def test_benchmark_adds_the_forward_row(self, models):
        from resnet_accel_tpu_torch.runtime.profile import profile_resnet18
        eng = InferenceEngine(models["port"], device="cpu")
        x = preprocess_imagenet(_images(2, seed=6))
        b = eng.benchmark(x, iters=2)
        assert b.device == "cpu" and b.batch == 2 and b.latency_s > 0
        (row,) = eng.profiler.records
        prof = profile_resnet18(models["port"], input_hw=32, batch=2)
        assert row.name == "forward" and row.latency_s == b.latency_s
        assert row.total_ops == sum(r.total_ops for r in prof.records)
        assert row.bytes_accessed == sum(r.bytes_accessed
                                         for r in prof.records)

    def test_profile_table(self, models):
        eng = InferenceEngine(models["port"], device="cpu")
        table = eng.profile(preprocess_imagenet(_images(2, seed=7)), iters=2)
        names = [ln.split()[0] for ln in table.splitlines()[1:-1]]
        assert names == [r.name for r in eng.profiler.records]
        assert names[0] == "stem" and names[-1] == "fc"
        assert "b1.ds" in names

    def test_staging_ring(self):
        from resnet_accel_tpu_torch.runtime.engine import _StagingRing
        with pytest.raises(ValueError, match="depth"):
            _StagingRing(torch.device("cpu"), torch.int8, depth=0)
        one = _StagingRing(torch.device("cpu"), torch.float32, depth=1)
        a = one.buffer((2, 3))
        one.upload()
        assert one.buffer((2, 3)) is a
        ring = _StagingRing(torch.device("cpu"), torch.int8, depth=2)
        a = ring.buffer((2, 3))
        a.fill_(1)
        assert ring.upload() is a
        b = ring.buffer((2, 3))
        assert b is not a
        ring.upload()
        assert ring.buffer((2, 3)) is a              # round again
        assert ring.buffer((4, 3)) is not a          # a new shape
