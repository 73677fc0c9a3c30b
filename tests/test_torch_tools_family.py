"""PyTorch port: ``tools/family_bench.py`` on the port
(``resnet_accel_tpu_torch/tools/family_bench.py``): GMACs an image at every
depth of the family against the JAX ``profile_resnet18`` count (exact: the
same integer count of multiply-accumulates), and one row formed on the CPU
at a small input (its fields, the plain path's agreement, the markdown
table).  The models are calibrated at 32 x 32, which leaves their layers,
and so the 224 x 224 count, as they are.
"""

import numpy as np
import pytest
import torch

from resnet_accel_tpu.models.resnet import init_resnet_fp32 as j_init
from resnet_accel_tpu.models.resnet import quantize_resnet as j_quantize
from resnet_accel_tpu.runtime.profile import profile_resnet18 as j_profile
from resnet_accel_tpu_torch.models.resnet import (init_resnet_fp32,
                                                  quantize_resnet)
from resnet_accel_tpu_torch.tools import family_bench

torch.set_num_threads(2)


@pytest.mark.parametrize("depth", family_bench.DEPTHS)
def test_gmacs_per_image_equals_jax(depth):
    calib = np.random.default_rng(0).normal(0, 1, (1, 3, 32, 32)).astype(
        np.float32)
    jm = j_quantize(j_init(depth=depth, seed=0, small_input=False), calib,
                    depth=depth, small_input=False)
    want = sum(r.total_ops for r in j_profile(jm, batch=1).records) // 2
    pm = quantize_resnet(init_resnet_fp32(depth=depth, seed=0,
                                          small_input=False), calib,
                         depth=depth, small_input=False)
    got = family_bench.gmacs_per_image(pm)
    assert got == want / 1e9
    # the published counts (torchvision's, in GMACs at 224 x 224)
    assert round(got, 1) == {18: 1.8, 34: 3.7, 50: 4.1, 101: 7.8,
                             152: 11.5}[depth]


def test_row_formed_on_the_cpu(capsys):
    row = family_bench.bench_depth(18, batch=2, chain=2, iters=1, hw=64,
                                   device="cpu", label="cpu")
    assert set(row) == {"depth", "batch", "img_per_s", "chained_ms",
                        "xprof_device_us", "xprof_img_per_s",
                        "gmacs_per_img", "mfu_int8", "top_scopes_us",
                        "plain_identical", "quantize_s"}
    assert row["depth"] == 18 and row["batch"] == 2
    assert row["plain_identical"] is True
    assert row["img_per_s"] > 0 and row["chained_ms"] > 0
    assert row["xprof_device_us"] > 0
    assert row["gmacs_per_img"] == pytest.approx(1.814073344)
    assert 0 < row["mfu_int8"] < 1
    top = row["top_scopes_us"]
    assert 1 <= len(top) <= 6 and list(top.values()) == sorted(
        top.values(), reverse=True)
    assert set(top) <= {"stem", "pool", "fc"} | {
        f"b{i}.{c}" for i in range(8) for c in ("c1", "c2", "ds")}
    table = family_bench.table([row])
    assert table.splitlines()[2].startswith("| -18 | 1.814 |")
    assert "logits of 2 images equal the plain path's  (cpu)" in \
        capsys.readouterr().out


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        family_bench.main(["18", "--batch", "2"])
