"""PyTorch port: K7's Hopper route on the CPU -- its route choice, its walk
over the tiles, its epilogue's lane map and its exact arithmetic.

``csrc/expand_add.cu`` runs ResNet's c3 convs on ``sm90_gemm_s8.cuh``'s
main loop in K7's mode; a CUDA kernel has no CPU mode, so these tests hold
plain-Python models of what it computes against the plain version
(tolerance 0):

- ``expand_plan``: ``wgmma_tma`` where TMA takes the operands and the
  epilogue its 8-byte bias and factor loads, else ``mma_sync``;
- the persistent walk: CTA b takes tiles b, b + CTAs, ..., N tile fastest;
  every (M tile, N tile) once, at the four c3 shapes of ResNet-50 at batch
  128 and at a ragged M;
- ``join_tile``'s lane map: each consumer thread's column pairs of its
  two accumulator rows, at the shared-memory places where TMA puts the
  residual's bytes and takes the output's (the TMA swizzle), cover the
  128 x 128 tile once, with no bank conflict in any warp's access;
- the epilogue's rounding by an add of 1.5 * 2^23 (``kRound``), in numpy
  float32 step for step: its requant against ``requantize`` (ties and
  saturation included), its join (clamped on the bits as integers)
  against ``add_residual`` on all 256 x 256 int8 pairs, by the divide and
  by the proven reciprocal.
"""

import numpy as np
import pytest
import torch

from resnet_accel_tpu_torch import _kernels, ops
from resnet_accel_tpu_torch.models.resnet import trunk_convs
from resnet_accel_tpu_torch.ops import expand_fused

torch.set_num_threads(2)

CL = torch.channels_last
#: The c3 of ResNet-50 at batch 128: (C_in, C_out, H), each stage once.
C3 = sorted({(c.C, c.O, c.H) for c in trunk_convs(50)
             if c.name.endswith(".c3")})


def _i8(shape, offset=0, cl=True):
    """An int8 tensor of ``shape`` whose data starts ``offset`` bytes past
    a 64-byte aligned allocation; channels-last for 4-d shapes."""
    n = int(np.prod(shape))
    flat = torch.empty(n + 64, dtype=torch.int8)
    lead = (-flat.data_ptr()) % 64 + offset
    t = flat[lead:lead + n]
    if len(shape) == 4 and cl:
        N, C, H, W = shape
        return t.view(N, H, W, C).permute(0, 3, 1, 2)
    return t.view(shape)


def test_c3_shapes():
    assert C3 == [(64, 256, 56), (128, 512, 28), (256, 1024, 14),
                  (512, 2048, 7)]


def _vec(n, dtype, offset=0):
    """A [n] vector of ``dtype`` starting ``offset`` bytes past a 64-byte
    aligned allocation."""
    return _i8((n * dtype.itemsize,), offset).view(dtype)


@pytest.mark.parametrize("C,O,H", C3)
def test_plan_takes_the_hopper_route_at_every_c3(C, O, H):
    x, w, r = _i8((2, C, H, H)), _i8((O, C)), _i8((2, O, H, H))
    plan = ops.expand_plan(x, w, _vec(O, torch.int32),
                           _vec(O, torch.float32), r)
    assert plan == _kernels.GemmPlan("wgmma_tma", expand_fused.BN, 1)


@pytest.mark.parametrize("C,O,offsets", [
    (12, 20, (0, 0, 0, 0, 0)), (64, 20, (0, 0, 0, 0, 0)),
    (20, 64, (0, 0, 0, 0, 0)), (64, 256, (4, 0, 0, 0, 0)),
    (64, 256, (0, 8, 0, 0, 0)), (64, 256, (0, 0, 4, 0, 0)),
    (64, 256, (0, 0, 0, 4, 0)), (64, 256, (0, 0, 0, 0, 4))])
def test_plan_refused_by_tma_runs_mma_sync(C, O, offsets):
    """C_in or C_out off a multiple of 16, x, w or the residual off a
    16-byte boundary, or bias or factors off an 8-byte one: the Hopper
    route does not take it, the route is mma_sync."""
    ox, ow, orr, ob, of = offsets
    x, w, r = _i8((2, C, 3, 3), ox), _i8((O, C), ow), _i8((2, O, 3, 3), orr)
    b, f = _vec(O, torch.int32, ob), _vec(O, torch.float32, of)
    assert (x.data_ptr() % 16, w.data_ptr() % 16, r.data_ptr() % 16,
            b.data_ptr() % 8, f.data_ptr() % 8) == offsets
    assert ops.expand_plan(x, w, b, f, r) == \
        _kernels.GemmPlan("mma_sync", 0, 1)


def _walk(m_tiles, n_tiles, ctas):
    """The tiles each persistent CTA takes, in its order: (M tile, N tile)
    of tiles b, b + ctas, ... (``gemm_s8_kernel`` with split 1)."""
    tiles = m_tiles * n_tiles
    return [[(t // n_tiles, t % n_tiles) for t in range(b, tiles, ctas)]
            for b in range(ctas)]


@pytest.mark.parametrize("M,C,O", [(128 * H * H, C, O) for C, O, H in C3]
                         + [(3 * 7 * 7, 512, 2048), (130, 64, 256)])
def test_walk_covers_every_tile_once(M, C, O):
    """Every (M tile, N tile) once, every output row below M once, none
    past it, at as many CTAs as the H100 holds (two an SM)."""
    m_tiles, n_tiles = -(-M // expand_fused.BM), -(-O // expand_fused.BN)
    ctas = min(m_tiles * n_tiles, 2 * _kernels.H100_SMS)
    walks = _walk(m_tiles, n_tiles, ctas)
    seen = [t for walk in walks for t in walk]
    assert sorted(seen) == [(m, n) for m in range(m_tiles)
                            for n in range(n_tiles)]
    rows = np.zeros(m_tiles * expand_fused.BM, np.int64)
    for m, n in seen:
        if n == 0:
            rows[m * expand_fused.BM:(m + 1) * expand_fused.BM] += 1
    assert (rows[:M] == 1).all() and rows[M:].sum() == m_tiles * 128 - M
    # the CTAs at work at once take neighbouring tiles, N tile fastest:
    # each wave reads at most ctas / n_tiles + 1 M tiles of A
    for k in range(0, m_tiles * n_tiles, ctas):
        wave = {t // n_tiles for t in range(k, min(k + ctas,
                                                   m_tiles * n_tiles))}
        assert len(wave) <= ctas // n_tiles + 2


def _tma_offset(r, c):
    """Byte (r, c) of a K7 tile in shared memory as TMA loads and stores
    it: one box of 128 bytes by 128 rows with the 128-byte swizzle --
    each row's 16-byte chunks XORed with the address's bits [7, 10)."""
    addr = r * 128
    return addr + (((c >> 4) ^ ((addr >> 7) & 7)) << 4) + (c & 15)


def _join_tile_offsets():
    """``join_tile``'s shared-memory address of each (thread, j, h) pair,
    as the kernel computes it: the lane's base in row r0, chunk j / 2
    XORed with r0's low 3 bits, 8 bytes for odd j, 8 rows for h."""
    out = {}
    for tid in range(256):
        warp, lane = tid // 32, tid % 32
        r0 = (warp // 4) * 64 + (warp % 4) * 16 + lane // 4
        lq = lane % 4
        for j in range(expand_fused.BN // 8):
            at = (r0 * 128 + 2 * lq + (((j >> 1) ^ (r0 & 7)) << 4)
                  + 8 * (j & 1))
            for h in range(2):
                out[tid, j, h] = (r0 + 8 * h, 8 * j + 2 * lq,
                                  at + 1024 * h)
    return out


def test_join_tile_lane_map():
    """Each consumer thread's pair (8j + 2lq, +1) of rows r0 and r0 + 8
    (the wgmma accumulator fragment's places) sits where the TMA put the
    residual and takes the output from; the 256 threads cover the 128 x
    128 tile once; and no warp's two-byte access meets a bank conflict."""
    offs = _join_tile_offsets()
    tile = np.zeros(128 * expand_fused.BN, np.int64)
    for (tid, j, h), (r, c, at) in offs.items():
        assert at == _tma_offset(r, c) and at + 1 == _tma_offset(r, c + 1)
        tile[at:at + 2] += 1
    assert (tile == 1).all()
    for warp in range(8):
        for j in range(expand_fused.BN // 8):
            for h in range(2):
                words = {offs[32 * warp + lane, j, h][2] // 4
                         for lane in range(32)}
                banks = {w % 32 for w in words}
                assert len(banks) == len(words), (warp, j, h)


# ---- the epilogue's arithmetic, float32 step for step ---------------------

K_ROUND = np.float32(12582912.0)        # 1.5 * 2^23, bits 0x4B400000


def _requant_f32(acc, f):
    """``requant_f32``: clamp f32(acc) * f to [-128, 127], add kRound and
    take it away again."""
    y = acc.astype(np.float32) * f
    y = np.minimum(np.maximum(y, np.float32(-128)), np.float32(127))
    return (y + K_ROUND) + (-K_ROUND)


def _join_bits(z, r, s_main, s_res, s_out, inv):
    """``join_bits`` on float32 z and int8 r, as int8: the clamp to [0,
    127] on the bits as int32, the add of kRound, the low byte."""
    s = z * np.float32(s_main) + r.astype(np.float32) * np.float32(s_res)
    t = s * np.float32(inv) if inv is not None else s / np.float32(s_out)
    q = np.minimum(np.maximum(t.view(np.int32), 0), 0x42FE0000)
    bits = (q.view(np.float32) + K_ROUND).view(np.uint32)
    return (bits & 0xff).astype(np.uint8).view(np.int8)


def test_requant_f32_matches_requantize():
    """Ties (x.5 at factors 0.5 and 0.25), saturation both ways, the
    int32 extremes, |f32(acc)| past 2^24 and a seeded spread."""
    rng = np.random.default_rng(0)
    acc = np.concatenate([
        np.arange(-600, 600), [2**31 - 1, -2**31, 2**24 + 1, -2**24 - 3],
        rng.integers(-2**31, 2**31, 20000)]).astype(np.int32)
    for f in (0.5, 0.25, 1 / 3, 0.2, 1e-4, 7.3e-3, 3.0, 1e-9):
        f32 = np.float32(f)
        got = _requant_f32(acc, f32)
        want = ops.requantize(torch.from_numpy(acc),
                              torch.tensor([f32]), relu=False).numpy()
        np.testing.assert_array_equal(got, want.astype(np.float32),
                                      err_msg=str(f))


@pytest.mark.parametrize("scales", [
    (0.0213, 0.0172, 0.0311), (0.05, 0.061, 0.043), (0.05, 0.06, 0.07),
    (1.644742727279663, 0.680426299571991, 1.3817954063415527),
    (0.5, 0.25, 0.125), (2.0, 1.0, 0.013)])
def test_join_bits_matches_add_residual_on_every_pair(scales):
    """All 256 x 256 int8 pairs (z, r): by the divide, and by the proven
    reciprocal where there is one; against ``add_residual`` with its
    ReLU."""
    z, r = (a.ravel().astype(np.int8) for a in np.meshgrid(
        np.arange(-128, 128), np.arange(-128, 128)))
    inv = ops.exact_inv_out_scale(*scales)
    for v in (None, inv) if inv is not None else (None,):
        want = ops.add_residual(torch.from_numpy(z), torch.from_numpy(r),
                                *scales, relu=True, inv_out_scale=v)
        np.testing.assert_array_equal(
            _join_bits(z.astype(np.float32), r, *scales, v), want.numpy())
