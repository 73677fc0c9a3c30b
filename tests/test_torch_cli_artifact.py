"""PyTorch port: the CLI's artifact flow (``quantize``, ``export``, ``sim``,
``verify``, ``fixtures``, ``bench --artifact``, ``test``) against the JAX
package's CLI.

Both CLIs run in this process on the same seeded inputs: every file they
write must be byte-identical, their exit codes and ``verify``'s report
equal.  ``bench --artifact`` runs on the CPU here (K4's plain version, host
time); its timing has no JAX counterpart, only its fields and its
bit-exactness.
"""

import json
import os

import numpy as np
import pytest
import torch

from resnet_accel_tpu import cli as jcli
from resnet_accel_tpu.train.mnist import load_checkpoint as jload_checkpoint
from resnet_accel_tpu_torch import cli
from resnet_accel_tpu_torch.checkpoint import load_checkpoint

torch.set_num_threads(2)

#: The MNIST CNN's parameters under the JAX package's names and shapes.
MNIST = {"conv1": (32, 1, 3, 3), "conv2": (64, 32, 3, 3),
         "fc1": (128, 9216), "fc2": (10, 128)}


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _both(tmp_path, capsys, *argv, out_flag="--output"):
    """Run ``argv`` through both CLIs, each writing under its own
    directory (the argument after ``out_flag`` is joined to it): their
    exit codes and stdouts (that directory printed as OUT), port first."""
    res = []
    for name, main in (("port", cli.main), ("jax", jcli.main)):
        args = list(argv)
        if out_flag in args:
            i = args.index(out_flag) + 1
            args[i] = str(tmp_path / name / args[i])
            os.makedirs(tmp_path / name, exist_ok=True)
        rc = main(args)
        res.append((rc, capsys.readouterr().out.replace(
            str(tmp_path / name), "OUT")))
    return res


@pytest.fixture
def checkpoint(tmp_path):
    rng = np.random.default_rng(0)
    ck = {}
    for layer, shape in MNIST.items():
        fan_in = int(np.prod(shape[1:]))
        ck[f"{layer}.weight"] = rng.normal(
            0, np.sqrt(2.0 / fan_in), shape).astype(np.float32)
        ck[f"{layer}.bias"] = rng.normal(0, 0.05, shape[0]).astype(np.float32)
    path = str(tmp_path / "ck.npz")
    np.savez(path, **ck)
    return path


def test_load_checkpoint(checkpoint):
    got, want = load_checkpoint(checkpoint), jload_checkpoint(checkpoint)
    assert list(got) == list(want)
    for k in got:
        assert np.array_equal(got[k], want[k])
    assert list(load_checkpoint(checkpoint[:-4])) == list(got)


def test_quantize_equals_jax_and_serves(tmp_path, capsys, checkpoint):
    (rc, out), (jrc, jout) = _both(tmp_path, capsys, "quantize",
                                   "--checkpoint", checkpoint,
                                   "--output", "q")
    assert rc == jrc == 0 and out == jout
    tree = _tree(tmp_path / "port" / "q")
    assert tree == _tree(tmp_path / "jax" / "q") and len(tree) == 17
    meta = json.loads(tree["quantization_metadata.json"])
    assert meta["fc1.bias"]["quantization"] == "per_tensor"
    # the layout infer --model mnist reads
    digits = np.random.default_rng(1).integers(0, 256, (3, 28, 28)).astype(
        np.uint8)
    np.save(tmp_path / "digits.npy", digits)
    rc = cli.main(["infer", "--model", "mnist", "--weights",
                   str(tmp_path / "port" / "q"), "--input",
                   str(tmp_path / "digits.npy"), "--device", "cpu"])
    assert rc == 0 and capsys.readouterr().out.count("sample ") == 3


def _weights(tmp_path, kind):
    rng = np.random.default_rng(2)
    if kind == "int8":
        w = rng.integers(-128, 128, (128, 9216)).astype(np.int8)
        keep = rng.random((10, 659)) >= 0.9
        w *= np.repeat(np.repeat(keep, 14, 0), 14, 1)[:128, :9216].astype(
            np.int8)
    elif kind == "conv":
        w = rng.normal(0, 0.1, (64, 32, 3, 3)).astype(np.float32)
        w[:, :8] = 0.0
    else:
        w = rng.normal(0, 0.1, (70, 300)).astype(np.float32)
        w[:, 28:140] = 0.0
    path = str(tmp_path / f"{kind}.npy")
    np.save(path, w)
    if kind == "float_scales":
        np.save(tmp_path / "scales.npy",
                (np.abs(w).max(axis=1) / 100.0).astype(np.float32))
    return path


@pytest.mark.parametrize("kind,extra", [
    ("int8", []), ("float", ["--block-h", "8", "--block-w", "16"]),
    ("float_scales", ["--scales", "SCALES"]), ("conv", ["--block-h", "4",
                                                        "--block-w", "4"])])
def test_export_equals_jax(tmp_path, capsys, kind, extra):
    w = _weights(tmp_path, kind)
    extra = [str(tmp_path / "scales.npy") if e == "SCALES" else e
             for e in extra]
    (rc, out), (jrc, jout) = _both(tmp_path, capsys, "export", "--weights",
                                   w, "--output", "layer", "--name", "fc1",
                                   *extra)
    assert rc == jrc == 0
    assert out == jout
    tree = _tree(tmp_path / "port" / "layer")
    assert tree == _tree(tmp_path / "jax" / "layer") and len(tree) == 4


@pytest.fixture
def layer(tmp_path, capsys):
    """The 14 x 14 FC1 at 0.9, exported by the port."""
    w = _weights(tmp_path, "int8")
    assert cli.main(["export", "--weights", w, "--output",
                     str(tmp_path / "fc1"), "--name", "fc1"]) == 0
    capsys.readouterr()
    return str(tmp_path / "fc1")


def test_sim_equals_jax(tmp_path, capsys, layer):
    (rc, out), (jrc, jout) = _both(tmp_path, capsys, "sim", "--artifact",
                                   layer, "--output", "g.npy")
    assert rc == jrc == 0
    assert out == jout
    got, want = np.load(tmp_path / "port" / "g.npy"), np.load(
        tmp_path / "jax" / "g.npy")
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert got.shape == (1, 140)
    with open(tmp_path / "port" / "g.npy", "rb") as a, \
            open(tmp_path / "jax" / "g.npy", "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("flips,tol,shape", [
    (0, 0, None), (1, 0, None), (12, 0, None), (1, 2, None), (0, 0, (2, 70))])
def test_verify_equals_jax(tmp_path, capsys, flips, tol, shape):
    rng = np.random.default_rng(flips)
    g = rng.integers(-2**20, 2**20, (1, 140)).astype(np.int32)
    a = g.copy() if shape is None else g.reshape(shape)
    a.flat[rng.choice(a.size, flips, replace=False)] += 1
    np.save(tmp_path / "g.npy", g)
    np.save(tmp_path / "a.npy", a)
    argv = ["verify", "--golden", str(tmp_path / "g.npy"), "--actual",
            str(tmp_path / "a.npy"), "--tolerance", str(tol)]
    (rc, out), (jrc, jout) = _both(tmp_path, capsys, *argv)
    assert rc == jrc and out == jout
    assert rc == (0 if (flips == 0 or tol >= 1) and shape is None else 1)
    assert ("PASS" in out) == (rc == 0)
    if rc and shape is None:
        assert f"FAIL: {flips} mismatches" in out
        assert out.count("  at ") == min(flips, 10)


def test_fixtures_equal_jax(tmp_path, capsys):
    (rc, out), (jrc, jout) = _both(tmp_path, capsys, "fixtures", "--output",
                                   "fx", "--seed", "3")
    assert rc == jrc == 0
    assert out == jout
    tree = _tree(tmp_path / "port" / "fx")
    assert tree == _tree(tmp_path / "jax" / "fx") and len(tree) == 12 * 7


@pytest.mark.parametrize("batch", [0, 3])
def test_bench_artifact_cpu(tmp_path, capsys, layer, batch):
    out_json = tmp_path / "row.json"
    rc = cli.main(["bench", "--artifact", layer, "--device", "cpu",
                   "--chain", "2", "--iters", "1", "--batch", str(batch),
                   "--output", str(out_json)])
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and row == json.loads(out_json.read_text())
    for key in ("artifact", "M", "K", "N", "nnz_blocks", "block",
                "bit_exact", "latency_us", "gops"):
        assert key in row, key
    assert row["bit_exact"] is True
    assert (row["M"], row["K"], row["N"]) == (max(batch, 1), 9216, 128)
    assert row["block"] == "14x14" and row["device"] == "cpu"
    assert row["launches"] == 0 and row["latency_us"] > 0
    nnz = row["nnz_blocks"]
    assert row["gops"] == pytest.approx(
        2 * nnz * 196 * row["M"] / (row["latency_us"] * 1e-6) / 1e9)


def test_bench_artifact_refuses(tmp_path, layer):
    with pytest.raises(SystemExit, match="--chain"):
        cli.main(["bench", "--artifact", layer, "--device", "cpu",
                  "--chain", "1"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(["bench", "--artifact", layer])


def test_chain_on_cpu(layer):
    """``bench --artifact``'s chain on the CPU: a loop of dependent calls,
    each feeding the low bits of K4's output back into A in place."""
    from resnet_accel_tpu_torch.ops import bsr_matmul_wt_plain, pack_bsr
    from resnet_accel_tpu_torch.sparse import load_layer_dir, regroup_bsr
    pk = pack_bsr(regroup_bsr(load_layer_dir(layer)), "cpu")
    a = torch.from_numpy(((np.arange(9216) % 256) - 128).astype(
        np.int8)[None])
    want = a.clone()
    chain = cli.Chain(cli.artifact_step(pk, 128), a, 3)
    assert chain() is a and chain() is a and chain.runs == 2
    for _ in range(6):
        out = bsr_matmul_wt_plain(want, pk)
        want[:, :128] += (out[:, :128] & 1).to(torch.int8)
    assert torch.equal(a, want)


@pytest.mark.parametrize("jax_present", [True, False])
@pytest.mark.parametrize("fail_fast", [False, True])
def test_test_argv(monkeypatch, capsys, jax_present, fail_fast):
    import importlib.util

    import pytest as pytest_mod
    seen = []
    monkeypatch.setattr(pytest_mod, "main", lambda argv: seen.append(argv)
                        or 0)
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: (
        real(name, *a) if jax_present or name != "jax" else None))
    assert cli.main(["test"] + (["--fail-fast"] if fail_fast else [])) == 0
    (argv,) = seen
    first = capsys.readouterr().out.splitlines()[0]
    names = [os.path.basename(a) for a in argv if a.endswith(".py")]
    assert ("-x" in argv) == fail_fast and "-q" in argv
    assert all(n.startswith("test_torch_") for n in names)
    assert "test_torch_kernels.py" in names
    if jax_present:
        assert "--noconftest" not in argv
        assert {"test_torch_sparse_io.py", "test_torch_attention.py",
                "test_torch_cli_artifact.py"} <= set(names)
        assert first == f"running the port's {len(names)} test files"
    else:
        assert argv[0] == "--noconftest"
        assert "test_torch_sparse_io.py" not in names
        assert "test_torch_cli_artifact.py" not in names
        assert first.startswith("jax is not installed") and \
            "test_torch_kernels.py" in first
