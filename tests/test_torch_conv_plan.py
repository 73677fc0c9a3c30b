"""PyTorch port: K2's path by shape and the addressing of its Hopper path's
A tiles, on the CPU.

K2's Hopper path (``csrc/conv_int8.cu`` on ``csrc/sm90_gemm_s8.cuh``)
never materialises the im2col matrix: a TMA map in im2col mode over the
channels-last input hands it, for each 128-pixel M tile and each K stage
(one tap's bk channel bytes), the stage's slice of the conv windows.
``im2col_map`` below is the map's pixel box as the kernel encodes it
(``make_im2col_map``), and ``im2col_tile`` models what one load brings:
the walk from the tile's first window across row and image ends at the
conv's stride, the tap as the im2col offsets, zeros outside x.  The tests
hold those tiles equal to the rows of the JAX package's ``im2col_nchw``
(reordered to the kernel's (kh, kw, c) K order) at every trunk conv shape
of ResNet-18 and ResNet-50, at reduced batch and spatial size, with
ragged last M tiles and odd sizes at stride 2.  Exact: it is indexing.
These are models of the C++ map, not the map itself: the card test
``test_conv_trunk_shapes`` (tests/test_torch_kernels.py) holds the
kernel's real corners at the same shapes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from resnet_accel_tpu.ops.conv import im2col_nchw as j_im2col_nchw
from resnet_accel_tpu_torch import _kernels
from resnet_accel_tpu_torch.models.resnet import trunk_convs
from resnet_accel_tpu_torch.ops.conv import (Padding, _out_hw, _pads,
                                             conv2d_int8, conv_plan,
                                             pack_weight)

torch.set_num_threads(2)

#: The Hopper path's output pixels a tile (the GEMM's M tile).
CONV_BM = 128


def conv_stage_bytes(C: int) -> int:
    """The Hopper path's K stage: one tap's channel bytes, 128, 64 or 32
    (``conv_int8_launch``'s ``bk``)."""
    return 128 if C % 128 == 0 else 64 if C % 64 == 0 else 32


def im2col_map(H: int, W: int, kernel: int, stride: int, padding: Padding,
               Ho: int, Wo: int):
    """The pixel box of the kernel's im2col map over x [N, H, W, C] (as
    ``csrc/sm90_gemm_s8.cuh::make_im2col_map`` encodes it): the lower
    corner (w, h), relative to the tensor's origin; the upper corner,
    relative to its far edge (W - 1, H - 1); the traversal stride.  The box
    holds the top-left taps of the Ho x Wo windows."""
    (t, _), (l, _) = _pads(padding)
    lower = (-l, -t)
    upper = (-l + (Wo - 1) * stride - (W - 1),
             -t + (Ho - 1) * stride - (H - 1))
    return lower, upper, stride


def im2col_tile(x_nhwc: torch.Tensor, kernel: int, stride: int,
                padding: Padding, m0: int, k0: int, bk: int,
                rows: int = CONV_BM) -> torch.Tensor:
    """What one TMA load of the kernel's im2col map brings for the M tile
    at output pixel ``m0`` and the K stage at byte ``k0`` (K index (kh, kw,
    c)): ``rows`` pixels of ``bk`` channels.  The load starts at the top-
    left tap of pixel m0's window, steps through the map's pixel box at its
    stride across row and image ends, adds the tap (kw, kh) as the im2col
    offsets and reads zero outside x."""
    N, H, W, C = x_nhwc.shape
    Ho, Wo = _out_hw(H, W, kernel, stride, padding)
    (lw, lh), (uw, uh), s = im2col_map(H, W, kernel, stride, padding, Ho,
                                       Wo)
    nw = (W - 1 + uw - lw) // s + 1          # box positions along W, H
    nh = (H - 1 + uh - lh) // s + 1
    tap, c = divmod(k0, C)
    kh, kw = divmod(tap, kernel)
    # the start, as the kernel computes it from m0 (pixel_of)
    n, r = divmod(m0, Ho * Wo)
    h0, w0 = (r // Wo) * stride + lh, (r % Wo) * stride + lw
    first = (n * nh + (h0 - lh) // s) * nw + (w0 - lw) // s
    out = torch.zeros((rows, bk), dtype=x_nhwc.dtype)
    for j in range(rows):
        n_j, rest = divmod(first + j, nh * nw)
        ih = lh + (rest // nw) * s + kh
        iw = lw + (rest % nw) * s + kw
        if 0 <= n_j < N and 0 <= ih < H and 0 <= iw < W:
            out[j] = x_nhwc[n_j, ih, iw, c:c + bk]
    return out


#: The stage inputs' spatial sizes at 224 x 224 and the reduced ones the
#: tests run (odd where a stride-2 conv reads them).
REDUCED_HW = {56: 15, 28: 9, 14: 7, 7: 5}


def test_trunk_convs():
    """19 convs in ResNet-18, 52 in ResNet-50 (36 on K2 and the 16 c3),
    named as the forward names them."""
    assert len(trunk_convs(18)) == 19
    r50 = trunk_convs(50)
    assert len(r50) == 52
    assert sum(c.name.endswith(".c3") for c in r50) == 16
    assert trunk_convs(18)[:3] == [("b0.c1", 1, 64, 64, 56, 3, 1),
                                   ("b0.c2", 1, 64, 64, 56, 3, 1),
                                   ("b1.c1", 1, 64, 64, 56, 3, 1)]
    assert ("b2.ds", 2, 64, 128, 56, 1, 2) in trunk_convs(18)
    assert ("b3.c2", 2, 128, 128, 56, 3, 2) in r50


@pytest.mark.parametrize("depth", [18, 50])
def test_every_trunk_conv_takes_the_hopper_path(depth):
    for _, _, C, O, H, k, s in trunk_convs(depth):
        assert conv_plan(C) == "wgmma_tma"
        assert conv_stage_bytes(C) in (64, 128)
        assert (k * k * C) % conv_stage_bytes(C) == 0


@pytest.mark.parametrize("C,want", [
    (12, "mma_sync"),    # the space-to-depth stem's 4x4 conv
    (4, "mma_sync"),     # the MNIST conv1 (1 channel padded to 4)
    (8, "mma_sync"), (16, "mma_sync"), (48, "mma_sync"),
    (32, "wgmma_tma"),   # the MNIST conv2
    (64, "wgmma_tma"), (96, "wgmma_tma"), (2048, "wgmma_tma")])
def test_path_by_shape(C, want):
    assert conv_plan(C) == want
    if want == "wgmma_tma":
        assert conv_stage_bytes(C) == (128 if C % 128 == 0 else
                                       64 if C % 64 == 0 else 32)


def test_cpu_call_runs_the_plain_version_and_counts_nothing():
    x = torch.zeros((1, 64, 5, 5), dtype=torch.int8).contiguous(
        memory_format=torch.channels_last)
    w = pack_weight(np.zeros((64, 576), np.int8), 64, 3, "cpu")
    before = _kernels.launch_counts()["conv_int8"]
    conv2d_int8(x, w, torch.zeros(64, dtype=torch.int32),
                torch.ones(64), padding=1)
    assert _kernels.launch_counts()["conv_int8"] == before


def _shapes():
    seen = []
    for depth in (18, 50):
        for _, _, C, O, H, k, s in trunk_convs(depth):
            shape = (C, REDUCED_HW[H], k, s)
            if shape not in seen:
                seen.append(shape)
    return seen


@pytest.mark.parametrize("C,H,k,s", _shapes())
def test_a_tiles_equal_im2col_rows(C, H, k, s):
    """Every (M tile, K stage) of a batch of 3 (the last M tile ragged)."""
    N, p = 3, k // 2
    rng = np.random.default_rng(C + H + k + s)
    x = rng.integers(-128, 128, (N, C, H, H)).astype(np.int8)
    Ho = (H + 2 * p - k) // s + 1
    ref = np.asarray(j_im2col_nchw(jnp.asarray(x), k, s, p))
    # (c, kh, kw) -> the kernel's (kh, kw, c)
    ref = torch.from_numpy(ref.reshape(N * Ho * Ho, C, k * k).transpose(
        0, 2, 1).reshape(N * Ho * Ho, k * k * C).copy())
    xn = torch.from_numpy(x).permute(0, 2, 3, 1).contiguous()
    bk = conv_stage_bytes(C)
    M = N * Ho * Ho
    assert M % CONV_BM or H == 5     # a ragged last tile where it can be
    for m0 in range(0, M, CONV_BM):
        rows = min(CONV_BM, M - m0)
        for k0 in range(0, k * k * C, bk):
            tile = im2col_tile(xn, k, s, p, m0, k0, bk)
            assert torch.equal(tile[:rows], ref[m0:m0 + rows, k0:k0 + bk]), \
                (m0, k0)


@pytest.mark.parametrize("H,k,s,p,Ho", [
    (56, 3, 1, 1, 56), (56, 3, 2, 1, 28), (15, 3, 2, 1, 8),
    (56, 1, 2, 0, 28), (7, 1, 1, 0, 7), (112, 4, 1, ((2, 1), (2, 1)), 112)])
def test_map_box(H, k, s, p, Ho):
    """The box holds exactly Ho positions a side at the stride, starting
    at the top-left tap of the first window, and fits the 8-bit corner
    fields of a 4D im2col map."""
    lower, upper, stride = im2col_map(H, H, k, s, p, Ho, Ho)
    assert stride == s
    for lo, up in zip(lower, upper):
        assert -128 <= lo <= 127 and -128 <= up <= 127
        assert (H - 1 + up - lo) // s + 1 == Ho
        assert lo + (Ho - 1) * s == H - 1 + up
