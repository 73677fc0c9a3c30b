"""PyTorch port: K3's K-major weight and the split-K schedule of K3 and K4,
against the JAX package on the CPU.

``matmul_int8`` keeps the JAX signature (b logically [K, N]) whether b is
the ``.t()`` view of a row-major [N, K], the layout the kernel takes as it
is, or a row-major [K, N], which the wrapper transposes once; both equal
the JAX ``matmul_int8(use_pallas=True)`` bit for bit.  The serving modules
hold their fc weights as such views, and their logits still equal the JAX
forward.  The split-K schedule the kernels compute (``cluster_split``,
``split_share``, ``bsr_plan``, ``matmul_plan``), walked in plain Python,
covers every stored block and K tile exactly once.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from resnet_accel_tpu.models import mnist_cnn as JM
from resnet_accel_tpu.models import resnet18 as JR
from resnet_accel_tpu.ops.matmul_int8 import matmul_int8 as j_matmul_int8
from resnet_accel_tpu_torch import _kernels, ops
from resnet_accel_tpu_torch.models import mnist_cnn as PM
from resnet_accel_tpu_torch.models import resnet18 as PR
from resnet_accel_tpu_torch.ops.matmul_int8 import weight_nk
from resnet_accel_tpu_torch.sparse import BSRMatrix, build_bsr_int8_direct

torch.set_num_threads(2)


def _i8(rng, shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


@functools.lru_cache(maxsize=None)
def _case(M, K, N, requant, relu):
    """Seeded a [M, K], W [N, K], bias, factors and the JAX result."""
    rng = np.random.default_rng(M + K + N)
    a, w = _i8(rng, (M, K)), _i8(rng, (N, K))
    bias = rng.integers(-20000, 20000, N).astype(np.int32)
    f = rng.uniform(1e-5, 1e-3, N).astype(np.float32) if requant else None
    want = np.asarray(j_matmul_int8(
        jnp.asarray(a), jnp.asarray(np.ascontiguousarray(w.T)),
        bias=jnp.asarray(bias), factors=None if f is None else jnp.asarray(f),
        relu=relu, use_pallas=True))
    return a, w, bias, f, want


@pytest.mark.parametrize("M,K,N", [(5, 37, 19), (128, 512, 1000),
                                   (128, 2048, 1000)])
@pytest.mark.parametrize("requant,relu", [(False, False), (False, True),
                                          (True, False), (True, True)])
@pytest.mark.parametrize("layout", ["nk_view", "kn"])
def test_matmul_layouts_vs_jax(M, K, N, requant, relu, layout):
    a, w, bias, f, want = _case(M, K, N, requant, relu)
    w_t = torch.from_numpy(w)
    b = w_t.t() if layout == "nk_view" else w_t.t().contiguous()
    assert b.shape == (K, N)
    assert b.is_contiguous() == (layout == "kn")
    # the kernel's weight: the view itself, or one transposed copy
    assert (weight_nk(b).data_ptr() == w_t.data_ptr()) == (
        layout == "nk_view")
    got = ops.matmul_int8(torch.from_numpy(a), b, bias=torch.from_numpy(bias),
                          factors=None if f is None else torch.from_numpy(f),
                          relu=relu)
    assert got.dtype == (torch.int8 if requant else torch.int32)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------- serving modules

def _k_major_view(t: torch.Tensor) -> bool:
    """[K, N] held as the .t() view of a row-major [N, K]."""
    return t.stride() == (1, t.shape[0]) and t.t().is_contiguous()


def test_resnet18_fc_weight_is_k_major_and_logits_equal_jax():
    stages = [(64, 1, 1), (128, 1, 2)]
    params = JR.init_resnet18_fp32(seed=0, num_classes=10, stages=stages)
    rng = np.random.default_rng(1)
    calib = rng.normal(0, 1, (2, 3, 64, 64)).astype(np.float32)
    ref = JR.quantize_resnet18(params, calib, 10, stages=stages)
    mod = PR.ResNet18Int8Module(PR.from_reference(ref), "cpu")
    assert _k_major_view(mod.fc_w)
    assert tuple(mod.fc_w.shape) == (ref.fc_w.shape[1], 10)
    x = rng.normal(0, 1, (2, 3, 64, 64)).astype(np.float32)
    got = mod(torch.from_numpy(x)).numpy()
    want = np.asarray(JR.make_forward(ref, use_pallas=True)(
        ref.as_device_params(), jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fc1_bsr", [False, True])
def test_mnist_fc_weights_are_k_major_and_logits_equal_jax(fc1_bsr):
    from resnet_accel_tpu_torch.quant import quantize_symmetric_per_channel
    rng = np.random.default_rng(2)
    shapes = {"conv1": (32, 1, 3, 3), "conv2": (64, 32, 3, 3),
              "fc1": (128, 9216), "fc2": (10, 128)}
    weights, scales, biases = {}, {}, {}
    for layer, shape in shapes.items():
        w = rng.normal(0, np.sqrt(2.0 / np.prod(shape[1:])),
                       shape).astype(np.float32)
        if layer == "fc1":
            w[np.repeat(np.repeat(rng.random((1, 72)) < 0.9, 128, 0), 128,
                        1)] = 0.0
        weights[layer], scales[layer] = quantize_symmetric_per_channel(w)
        biases[layer] = rng.normal(0, 0.05, shape[0]).astype(np.float32)
    ref = JM.MNISTCNNInt8.from_arrays(weights, scales, biases,
                                      (0.021, 0.0113, 0.0049, 0.0021))
    if fc1_bsr:
        ref = ref.with_fc1_bsr(128)
    mod = PM.MNISTCNNInt8Module(PM.from_reference(ref), "cpu")
    assert _k_major_view(mod.fc2_wT) and mod.fc2_wT.shape == (128, 10)
    if fc1_bsr:
        assert mod.fc1_wT is None and mod.fc1_packed is not None
    else:
        assert _k_major_view(mod.fc1_wT) and mod.fc1_wT.shape == (9216, 128)
    x = rng.normal(0, 1, (3, 1, 28, 28)).astype(np.float32)
    got = mod(torch.from_numpy(x)).numpy()
    want = np.asarray(JM.make_forward(ref, use_pallas=True)(
        ref.as_device_params(), jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------ split-K schedule

def _walk_bsr(packed, plan):
    """Every (block row, rank) share of the plan, as the kernel walks it:
    the stored blocks each CTA loads."""
    row_ptr = packed.row_ptr.tolist()
    seen = []
    for br in range(len(row_ptr) - 1):
        n = row_ptr[br + 1] - row_ptr[br]
        for rank in range(plan.split):
            seen += [row_ptr[br] + i for i in
                     _kernels.split_share(n, plan.split, rank)]
    return seen


def _mnist_fc1_packed(full_row: bool):
    rng = np.random.default_rng(21)
    W = _i8(rng, (128, 9216))
    W[np.repeat(np.repeat(rng.random((1, 72)) < 0.9, 128, 0), 128, 1)] = 0
    if full_row:                       # a second row storing all 72 blocks
        W = np.concatenate([W, _i8(rng, (128, 9216))])
    return ops.pack_bsr(build_bsr_int8_direct(W, 128), "cpu")


def _empty_row_packed():
    rng = np.random.default_rng(7)
    W = _i8(rng, (384, 256))
    W[128:256] = 0                     # block row 1 stores nothing
    packed = ops.pack_bsr(build_bsr_int8_direct(W, 128), "cpu")
    assert packed.row_ptr.tolist()[1] == packed.row_ptr.tolist()[2]
    return packed


@pytest.mark.parametrize("which", ["mnist_fc1", "mnist_fc1_full_row",
                                   "empty_row"])
def test_bsr_schedule_covers_every_block_once(which):
    if which == "empty_row":
        packed, M = _empty_row_packed(), 300
    else:
        packed, M = _mnist_fc1_packed(which.endswith("full_row")), 128
    a = torch.zeros((M, packed.k_dim), dtype=torch.int8)
    plan = ops.bsr_plan(a, packed)
    assert plan.variant == "wgmma_tma" and plan.bn == 128
    counts = np.diff(packed.row_ptr.numpy())
    assert packed.max_row_blocks == counts.max()
    if which != "empty_row":           # one M tile: long rows are split
        assert plan.split == (2 if counts.max() > 8 else 1)
    seen = _walk_bsr(packed, plan)
    assert sorted(seen) == list(range(packed.nnz_source))
    for split in range(1, 9):          # any split walks each block once
        assert sorted(_walk_bsr(packed, _kernels.GemmPlan(
            "wgmma_tma", 128, split))) == list(range(packed.nnz_source))


@pytest.mark.parametrize("M,K,N,split", [(128, 512, 1000, 1),
                                         (128, 2048, 1000, 2),
                                         (128, 9216, 128, 2),
                                         (128, 128, 10, 1),
                                         (5, 37, 19, 1), (70, 129, 65, 1),
                                         (20000, 512, 1000, 1)])
def test_matmul_schedule(M, K, N, split):
    a = torch.zeros((M, K), dtype=torch.int8)
    w = torch.zeros((N, K), dtype=torch.int8)
    plan = ops.matmul_plan(a, w)
    assert plan.split == split and plan.bn == 64
    assert plan.variant == ("wgmma_tma" if K % 16 == 0 else "wgmma_ld")
    tiles = -(-K // 128)
    seen = [t for r in range(split) for t in
            _kernels.split_share(tiles, split, r)]
    assert seen == list(range(tiles))


@pytest.mark.parametrize("bh,bw,K,variant,bn", [
    (128, 128, 576, "wgmma_tma", 64), (128, 128, 9216, "wgmma_tma", 128),
    (256, 128, 512, "wgmma_tma", 256), (32, 32, 160, "wgmma_tma", 64),
    (14, 14, 9216, "wgmma_small", 16), (8, 8, 96, "wgmma_small", 16),
    (14, 14, 576, "wgmma_small", 16), (16, 16, 64, "wgmma_small", 16),
    (14, 14, 9220, "mma_sync", 0), (8, 8, 100, "mma_sync", 0),
    (16, 48, 192, "mma_sync", 0), (32, 32, 37, "mma_sync", 0)])
def test_bsr_plan_by_shape(bh, bw, K, variant, bn):
    """The Hopper path for blocks wgmma's tiles and TMA take, the small-
    block path for the other blocks of at most 16 x 16 (14 x 14, 8 x 8)
    where TMA takes A, the ``mma_sync`` path for the rest (widths off 32
    bytes above 16, K off 16)."""
    n_out = 64 if K == 576 else 2 * bh
    W = np.ones((n_out, K), np.int8)
    packed = ops.pack_bsr(build_bsr_int8_direct(W, bh, bw), "cpu")
    plan = ops.bsr_plan(torch.zeros((256, K), dtype=torch.int8), packed)
    assert (plan.variant, plan.bn) == (variant, bn)


def test_pack_bsr_longest_row_without_blocks():
    bsr = BSRMatrix(data=np.zeros((0, 128, 128), np.int8),
                    row_ptr=np.zeros(3, np.int32),
                    col_idx=np.zeros(0, np.int32), shape=(256, 256),
                    block_h=128, block_w=128)
    bsr.validate()
    packed = ops.pack_bsr(bsr, "cpu")
    assert packed.max_row_blocks == 0
    assert ops.bsr_plan(torch.zeros((8, 256), dtype=torch.int8),
                        packed).split == 1
