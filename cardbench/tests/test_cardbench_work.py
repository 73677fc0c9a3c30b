"""The operation and byte counts against hand counts."""

import numpy as np
import pytest

from cardbench import harness
from cardbench.reference.resnet_int8 import stored_blocks
from cardbench.work.resnet_int8 import bound_s, layers


def _config(name):
    bench = harness.load_bench()
    _, config, _ = harness.resolve(bench, name)
    return config


@pytest.mark.parametrize("cell, gmacs", [
    ("r50-offline-b128", 4.089),          # ResNet-50 at 224, dense
    ("r18bsr14-offline-b128", 1.814),     # ResNet-18 at 224, dense count
])
def test_dense_macs_per_image(cell, gmacs):
    config = dict(_config(cell), sparsity=None)
    total = sum(l.macs for l in layers(config, 1))
    assert total / 1e9 == pytest.approx(gmacs, abs=5e-4)
    # linear in the batch
    assert sum(l.macs for l in layers(config, 3)) == 3 * total


def test_resnet50_layer_kinds_and_a_dense_conv_by_hand():
    config = _config("r50-offline-b128")
    ls = {l.scope: l for l in layers(config, 2)}
    kinds = [l.kind for l in ls.values()]
    assert kinds.count("expand") == 16 and kinds.count("conv") == 36
    assert kinds.count("bsr") == 0
    # b0.c1: 1x1, 64 -> 64 on 56 x 56, no join
    c1 = ls["b0.c1"]
    assert c1.macs == 2 * 56 * 56 * 64 * 64
    assert c1.bytes == 2 * (56 * 56 * 64 * 2) + 64 * 64 + 8 * 64
    # b0.c3: 1x1, 64 -> 256 with the join: the residual is read as well
    c3 = ls["b0.c3"]
    assert c3.bytes == 2 * (56 * 56 * 64 + 2 * 56 * 56 * 256) \
        + 256 * 64 + 8 * 256
    # b3.c2: the 3x3 that carries the stride, 56 -> 28
    assert ls["b3.c2"].macs == 2 * 28 * 28 * 128 * 128 * 9
    fc = ls["fc"]
    assert fc.macs == 2 * 2048 * 1000
    assert fc.bytes == 2 * 2048 + 2048 * 1000 + 8 * 1000 + 4 * 2 * 1000


def test_stored_blocks_of_a_small_layer():
    # [20, 30] in 14 x 14 blocks: 2 x 3 blocks, the last row 6 high and
    # the last column 2 wide
    w = np.zeros((20, 30), np.int8)
    w[0, 0] = 1          # block (0, 0): 14 x 14 elements
    w[15, 29] = -3       # block (1, 2): 6 x 2
    w[19, 14] = 5        # block (1, 1): 6 x 14
    s = stored_blocks(w, 14, 14)
    assert s == {"blocks": 3, "elements": 196 + 12 + 84, "block_rows": 2}


def test_bsr_layer_counts_its_stored_blocks():
    config = _config("r18bsr14-offline-b128")
    stored = {"b0.c1": {"blocks": 10, "elements": 1900, "block_rows": 5}}
    ls = {l.scope: l for l in layers(config, 4, stored)}
    c1 = ls["b0.c1"]
    assert c1.kind == "bsr" and ls["b0.c2"].kind == "conv"
    assert c1.macs == 4 * 56 * 56 * 1900
    assert c1.bytes == 4 * (56 * 56 * 64 * 2) + 10 * (196 + 4) + 4 * 6 \
        + 8 * 64
    # a basic block's c2 joins its residual
    assert ls["b0.c2"].bytes == 4 * (56 * 56 * 64 * 3) + 64 * 576 + 8 * 64


def test_bound_takes_the_larger_side():
    config = _config("r50-offline-b128")
    c1 = {l.scope: l for l in layers(config, 128)}["b0.c1"]
    assert bound_s(c1, 1979e12, 3.35e12) == max(c1.ops / 1979e12,
                                                 c1.bytes / 3.35e12)
