"""The plain reference against the program on the CPU, the control that
has to fail, and a run whose timed path is broken underneath.

The program's kernels run only on a card; on CPU tensors its modules run
their plain PyTorch versions, which is what these tests hold the reference
against, at 32 x 32 images and 10 classes (every width as configured)."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from cardbench import compare, control, harness
from cardbench.drivers import offline
from cardbench.models import resnet_int8 as model
from cardbench.reference.resnet_int8 import Reference

CELLS = ["r18bsr14-offline-b128", "r50-offline-b128"]
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def tiny(cell, **traffic_kw):
    bench = harness.load_bench()
    c, config, traffic = harness.resolve(bench, cell)
    config = dict(config, image_size=32, num_classes=10)
    traffic = dict(traffic, batch=4, library_images=8, batches_per_call=2,
                   **traffic_kw)
    return bench, c, config, traffic


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the program's kernels run only there")
    return torch.device("cuda:0")


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [0, 2**31 + 9])
def test_reference_equals_the_program(cell, seed):
    _, _, config, _ = tiny(cell)
    inputs = model.inputs(config, seed, "cpu")
    x = model.images(config, seed, "x", 6, "cpu")
    prog = model.build(config, inputs)
    with torch.inference_mode():
        got = model.engine(prog, "cpu").module(model.quantize(prog, x))
    ref = Reference(config, inputs)
    assert ref.s_input == prog.s_input
    want = ref.logits(x)
    assert torch.equal(got, want)
    if config["sparsity"]:
        stored = {s: v["blocks"] for s, v in ref.stored().items()}
        assert stored == model.state(prog) and len(stored) == 19


@pytest.mark.parametrize("cell", CELLS)
def test_the_int4_control_fails_the_limit(cell):
    _, _, config, traffic = tiny(cell)
    widest, least = control.control_gaps(config, traffic, 3, "cpu")
    assert least > config["check"]["logit_gap"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    bench, c, config, traffic = tiny(cell)
    out = harness.run_cell(bench, c, config, traffic, 7, 0.1, False, "cpu",
                           time.perf_counter())
    assert out.result["correct"] is True
    assert out.result["failed"] == 0
    assert [n for n, _, _ in out.checks] == list(out.result["checks"])
    assert list(out.result)[-1] == "checks"


@pytest.mark.parametrize("fault", ["altered", "half", "stale"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault):
    bench, c, config, traffic = tiny(cell)
    with control.planted(fault, traffic["batch"]):
        out = harness.run_cell(bench, c, config, traffic, 8, 0.1, False,
                               "cpu", time.perf_counter())
    assert out.result["correct"] is False
    assert out.result["checks"]["logit_gap"]["value"] > \
        config["check"]["logit_gap"]


def test_a_missing_answer_is_not_correct(monkeypatch):
    bench, c, config, traffic = tiny(CELLS[1])
    from resnet_accel_tpu_torch.runtime.engine import InferenceEngine
    orig = InferenceEngine.stream

    def stream(self, loader, n):
        res = orig(self, loader, n)
        res.logits = res.logits[:-1]
        return res

    monkeypatch.setattr(InferenceEngine, "stream", stream)
    out = harness.run_cell(bench, c, config, traffic, 9, 0.1, False, "cpu",
                           time.perf_counter())
    assert out.result["correct"] is False
    assert out.result["checks"]["missing_answers"]["value"] > 0


def test_a_dense_model_on_a_sparse_configuration_is_not_correct(monkeypatch):
    bench, c, config, traffic = tiny(CELLS[0])
    monkeypatch.setattr(model, "state", lambda prog: {})
    out = harness.run_cell(bench, c, config, traffic, 10, 0.1, False, "cpu",
                           time.perf_counter())
    assert out.result["correct"] is False
    assert out.result["checks"]["sparse_layers_off"]["value"] == 19


def test_library_is_cycled_in_order():
    lib = offline.Library([np.zeros(1), np.ones(1), np.full(1, 2)])
    got = [int(lib.next()[0][0]) for _ in range(5)]
    assert got == [0, 1, 2, 0, 1] and lib.handed == got


def test_row_gaps():
    ref = np.array([[1.0, -2.0], [4.0, 0.5]])
    got = np.array([[1.0, -2.5], [np.nan, 0.5]])
    g = compare.row_gaps(got, ref)
    assert g[0] == pytest.approx(0.25) and g[1] == np.inf


def test_a_short_cell_on_the_card(cuda):
    """Both cells' whole runs on the card, short, correct."""
    for cell in CELLS:
        p = subprocess.run([sys.executable, "-m", "cardbench.run",
                            "--workload", cell, "--seed", "12345",
                            "--seconds", "1", "--trace", "0"], cwd=ROOT,
                           capture_output=True, text=True, timeout=1200)
        assert p.returncode == 0, p.stderr[-3000:]
        assert json.loads(p.stdout.splitlines()[-1])["correct"] is True
