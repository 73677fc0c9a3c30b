"""BENCHMARK.json against the contract's shape, and discovery by name: a
configuration, a traffic mix and a per-layer metric added as files and
entries, with no existing file edited, are found and run."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from cardbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def bench():
    return harness.load_bench()


def test_keys_names_units():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["cardbench"]
    assert 1 <= b["run_seconds"] <= 51   # the contract's range
    names = [c["name"] for c in b["configs"]] + [
        w["name"] for w in b["workloads"]] + [
        m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in b["workloads"]]:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        assert m["workloads"], m["name"]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("cardbench/")
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_every_cell_resolves_to_files_and_modules(cell):
    b = bench()
    _, config, traffic = harness.resolve(b, cell)
    kind = config["kind"]
    for pkg in ("models", "reference", "work"):
        assert os.path.exists(os.path.join(HERE, pkg, kind + ".py"))
    assert os.path.exists(os.path.join(HERE, "drivers",
                                       traffic["driver"] + ".py"))
    metrics = harness.per_layer_metrics(b, cell)
    assert metrics, cell
    for m in metrics:
        assert hasattr(harness.reader(m["name"]), "read")


def test_added_files_are_found_without_an_edit(tmp_path):
    """A copy of the benchmark gains a configuration (ResNet-34, dense), a
    traffic mix and a metric by new files and new entries only; a traced
    run of the new cell on the CPU reads the new metric."""
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = bench()
    cfg = json.load(open(os.path.join(HERE, "configs",
                                      "resnet50-v1.5-int8.json")))
    cfg.update(model="ResNet-34, INT8", block="basic", layers=[3, 4, 6, 3],
               image_size=32, num_classes=10)
    cfg.pop("expansion"), cfg.pop("stride_on")
    (root / "cardbench/configs/resnet34-tiny.json").write_text(
        json.dumps(cfg))
    (root / "cardbench/traffic/offline-b2-n2.json").write_text(json.dumps(
        dict(driver="offline", batch=2, library_images=4,
             batches_per_call=1)))
    (root / "cardbench/metrics/traced_batches.py").write_text(
        "def read(ctx):\n    return float(ctx.batches)\n")
    b["configs"].append(dict(name="resnet34-tiny", source="https://arxiv.org"
                             "/abs/1512.03385",
                             file="cardbench/configs/resnet34-tiny.json",
                             reduced=[], why="test"))
    b["workloads"].append(dict(name="r34-tiny", config="resnet34-tiny",
                               traffic="offline-b2-n2", chips=1, why="test"))
    b["per_layer"].append(dict(name="traced_batches", unit="batches",
                               better="higher", source="device_trace",
                               layer="device", moves="img_per_s",
                               workloads=["r34-tiny"]))
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    code = (
        "import json, time\n"
        "from cardbench import harness\n"
        "b = harness.load_bench()\n"
        "cell, config, traffic = harness.resolve(b, 'r34-tiny')\n"
        "out = harness.run_cell(b, cell, config, traffic, 11, 0.1, True,"
        " 'cpu', time.perf_counter())\n"
        "print(json.dumps(out.result))\n")
    env = dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{ROOT}")
    p = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.splitlines()[-1])
    assert res["correct"] is True
    assert res["metrics"] == {"traced_batches": {"value": 6.0,
                                                 "unit": "batches"}}
