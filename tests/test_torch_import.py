"""PyTorch port: it imports no JAX, it names its device explicitly, and a
CUDA request on a machine without a card fails instead of falling back."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import resnet_accel_tpu_torch
from resnet_accel_tpu_torch import cli
from resnet_accel_tpu_torch.runtime.backend import resolve_device

torch.set_num_threads(2)

PKG_DIR = os.path.dirname(resnet_accel_tpu_torch.__file__)
REPO = os.path.dirname(PKG_DIR)


def test_import_leaves_jax_out():
    """In a fresh interpreter (this one has JAX from conftest), importing
    every module of the port pulls in neither jax nor the JAX package."""
    code = ("import sys\n"
            "import resnet_accel_tpu_torch, resnet_accel_tpu_torch.cli\n"
            "import resnet_accel_tpu_torch.runtime.engine\n"
            "import resnet_accel_tpu_torch.ops, resnet_accel_tpu_torch._kernels\n"
            "import resnet_accel_tpu_torch.models.lm\n"
            "import resnet_accel_tpu_torch.ops.sparse_conv\n"
            "import resnet_accel_tpu_torch.ops.fused_stem\n"
            "import resnet_accel_tpu_torch.sparse.conv_bsr\n"
            "import resnet_accel_tpu_torch.sparse.io\n"
            "import resnet_accel_tpu_torch.sparse.fixtures\n"
            "import resnet_accel_tpu_torch.models.attention\n"
            "import resnet_accel_tpu_torch.checkpoint\n"
            "import resnet_accel_tpu_torch.quant\n"
            "import resnet_accel_tpu_torch.models.sampling\n"
            "import resnet_accel_tpu_torch.runtime.serving\n"
            "import resnet_accel_tpu_torch.runtime.paged\n"
            "import resnet_accel_tpu_torch.train\n"
            "import resnet_accel_tpu_torch.train.lm\n"
            "import resnet_accel_tpu_torch.utils.mnist_data\n"
            "import resnet_accel_tpu_torch.models.moe\n"
            "import resnet_accel_tpu_torch.runtime.paged_tp\n"
            "import resnet_accel_tpu_torch.parallel\n"
            "from resnet_accel_tpu_torch.parallel import (launch, mesh, "
            "collectives, sharded, heads, sequence, experts, pipeline, "
            "combined, jobs, dryrun)\n"
            "import resnet_accel_tpu_torch.parallel as P\n"
            "[getattr(P, n) for n in P.__all__]\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'optax', "
            "'orbax', 'resnet_accel_tpu') or m.startswith(('jax.', "
            "'jaxlib', 'optax.', 'orbax.', 'resnet_accel_tpu.')))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_jax_import_in_sources():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|optax|orbax|"
                     r"resnet_accel_tpu)\b", re.M)
    for root, _, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    assert not pat.search(fh.read()), f


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unknown device"):
        resolve_device("tpu")


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    from resnet_accel_tpu_torch.models.resnet18 import (
        ResNet18Int8Module, init_resnet18_fp32, quantize_resnet18)
    from resnet_accel_tpu_torch.runtime.engine import InferenceEngine
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    stages = [(64, 1, 1)]
    p = init_resnet18_fp32(seed=0, num_classes=4, small_input=True,
                           stages=stages)
    calib = np.random.default_rng(0).normal(0, 1, (1, 3, 8, 8))
    model = quantize_resnet18(p, calib, 4, small_input=True, stages=stages)
    with pytest.raises(RuntimeError, match="cuda"):
        InferenceEngine(model, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        ResNet18Int8Module(model, "cuda")


def test_cli_infer_cpu(tmp_path, capsys):
    x = np.random.default_rng(0).normal(0, 1, (3, 3, 32, 32))
    path = tmp_path / "x.npy"
    np.save(path, x.astype(np.float32))
    rc = cli.main(["infer", "--model", "resnet18", "--input", str(path),
                   "--device", "cpu", "--num-classes", "10",
                   "--small-input"])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.count("sample ") == 3 and "images/s on cpu" in out


def test_cli_infer_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    path = tmp_path / "x.npy"
    np.save(path, np.zeros((1, 3, 32, 32), np.float32))
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["infer", "--input", str(path), "--device", "cuda",
                  "--small-input", "--num-classes", "10"])
