"""Nothing the benchmark runs loads JAX or the JAX package: the names are
compared whole, because the program's name begins with the JAX
package's."""

import ast
import os
import subprocess
import sys

from cardbench.run import FORBIDDEN, forbidden_loaded

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def _sources():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imported(path):
    """Top-level names of every module ``path`` imports."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_whole_name_comparison():
    assert forbidden_loaded(["resnet_accel_tpu_torch",
                             "resnet_accel_tpu_torch.ops", "torch"]) == []
    assert forbidden_loaded(["resnet_accel_tpu.ops"]) == ["resnet_accel_tpu"]
    assert forbidden_loaded(["jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib"]
    assert forbidden_loaded(["jaxtyping", "flaxen"]) == []


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = set(_imported(path)) & FORBIDDEN
        assert not bad, f"{path} imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(HERE, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            names = set(_imported(os.path.join(ref, f)))
            assert "resnet_accel_tpu_torch" not in names, f
            assert names <= {"__future__", "dataclasses", "typing", "math",
                             "numpy", "torch"}, (f, names)


def test_a_run_loads_neither(tmp_path):
    """A whole run of a tiny cell on the CPU, in a fresh process, then
    the process's modules."""
    code = (
        "import sys, time\n"
        "from cardbench import harness\n"
        "from cardbench.run import forbidden_loaded\n"
        "bench = harness.load_bench()\n"
        "cell, config, traffic = harness.resolve(bench, 'r50-offline-b128')\n"
        "config = dict(config, image_size=32, num_classes=10)\n"
        "traffic = dict(traffic, batch=2, library_images=4,"
        " batches_per_call=2)\n"
        "out = harness.run_cell(bench, cell, config, traffic, 5, 0.1,"
        " False, 'cpu', time.perf_counter())\n"
        "assert out.result['correct'], out.result\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print('FORBIDDEN', forbidden_loaded())\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.splitlines()[-1] == "FORBIDDEN []"
    assert "resnet_accel_tpu_torch" in p.stdout


def test_no_card_no_result():
    """Without a CUDA card the run exits non-zero and prints nothing on
    standard output (this sandbox has none)."""
    import torch
    if torch.cuda.is_available():
        import pytest
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "cardbench.run", "--workload",
                        "r50-offline-b128", "--seed", "3", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
    assert "needs 1 CUDA card" in p.stderr
