// K4: block-sparse int8 GEMM that visits stored blocks only -- the zero-
// block skip -- on the int8 tensor cores, with a fused epilogue.
//
// Replaces resnet_accel_tpu/ops/bsr_matmul.py::_bsr_resident_kernel (and
// its per-block sibling _bsr_kernel), reached through bsr_matmul_wt: the
// sparse convs of the pruned ResNet-18 (after im2col), the MNIST CNN's fc1
// and the bench sweep.
//
// Computes C[M, N] = A[M, K] @ W^T, A int8 row-major, W[N, K] int8 in CSR
// blocks: the blocks of block row br are blocks[row_ptr[br] .. row_ptr[br
// + 1]), each [bh, bw] row-major (W's orientation, so a block row of W is
// K-contiguous: K-major, the layout both tensor-core paths want), at K
// offset col_idx[i] * bw.  Per output (m, n):
//   acc = sum over stored blocks (int32, exact) + bias[n]
//   acc = relu(acc) if relu
//   out = requant ? clip(rint(float(acc) * factors[n]), -128, 127) : acc
// A block row with no stored block writes its epilogue of a zero sum.
// M, N and K may be ragged.
//
// What bounds it on the H100: on the served model the work is the stored
// blocks' multiply-adds (77 G over the 18 sparse convs at batch 128) over
// im2col matrices of up to 231 MB, of which it must read the block
// columns some block row stores: bound by those bytes (0.1 to 0.3 ms over
// the 18 convs).  Three paths, chosen by the wrapper by shape:
//
// - The Hopper path (bw % 32 == 0, bh % 8 == 0, bh <= 256, K % 16 == 0,
//   16-byte aligned bases; every 128 x 128 path served) runs
//   sm90_gemm_s8.cuh's main loop: TMA, an mbarrier ring, wgmma.  One CTA
//   covers a whole block row (its N tile is the block row's height, or 64
//   where the row holds 64 outputs, as in the stage-1 convs), so each A
//   slab a stored block needs is read once per (M tile, block row); the
//   producer reads row_ptr and col_idx and loads the A box at (col_idx[i]
//   * bw, m0) and the block at (0, i * bh).  Persistent CTAs walk the
//   tiles, block row fastest, so that the CTAs at work share A's M tile
//   in L2.  Where M tiles x block rows leave half the card idle and a row
//   holds more than 8 blocks (the MNIST fc1), a cluster of two CTAs splits
//   each row's list of stored blocks.
// - The small-block path (bsr_small_kernel below; blocks of at most 16 x
//   16 that the Hopper path does not take -- the reference's 14 x 14, 8 x
//   8 -- under the same TMA preconditions).  At 14 x 14 a 128-wide tile
//   would hold one block row's 14 outputs in 64 columns: about 10 % of
//   each product.  Here one CTA computes one block row of a 128-row M tile
//   at an N of 16 (wgmma.m64n16k32, 14 of 16 columns live).  A block at
//   block column c covers A's K bytes [bw * c, bw * c + bw), which TMA
//   cannot load as such: a tiled load refuses an inner coordinate off 16
//   bytes (an illegal instruction on the H100, PERF.md).  So each block
//   takes one k32 step over the 32-byte aligned window that holds it, x0
//   = bw * c - (bw * c) % 16, and the host stores the block's W shifted
//   into that window, zero elsewhere (ops.bsr_matmul.small_stages): the
//   window's other bytes of A meet zeros, so the int32 sum stays exact;
//   past K the box is zero-filled.  A stage is two blocks of a row: two A
//   boxes of 32 bytes x 128 rows and one W box of 32 bytes x 32 rows, all
//   TMA with the 32-byte swizzle that the descriptors name (as the Hopper
//   path's 32-byte K boxes).  A producer lane keeps a ring of
//   kSmallStages stages in flight under mbarriers; one consumer
//   warpgroup issues the four wgmmas of a stage; grids that leave SMs
//   idle split each row's stages across a cluster, summed through
//   distributed shared memory as the Hopper path does.  Bound on the H100
//   by moving the A windows (8 KB a stage) from L2 into shared memory,
//   not by the tensor cores (PERF.md).
// - The mma.sync path below (any other block shape: 16 x 24, 16 x 48, or K
//   that TMA refuses): one block per (128-row M tile, 64-column slice
//   of one block row) walks its row's stored blocks only, consuming 32 K
//   values a step with mma.sync m16n8k32 (8 warps of 32 x 32), the next
//   step's A and W words fetched into registers while the tensor cores
//   work on the current step in shared memory (two stages), as K2 does.
//   Rows of a slice past bh are zero in shared memory and the epilogue
//   stores only the block row's own bh columns; when bw % 32 != 0 a
//   block's last K step is masked too, its bytes past bw zero (kWhole
//   false: 16-byte loads for whole aligned chunks, byte loads for the
//   rest).  A slice that holds only the padding of N returns at once.

#include <cuda_runtime.h>

#include <cstdint>

#include "epilogue.cuh"
#include "mma_s8.cuh"
#include "sm90_gemm_s8.cuh"

namespace {

constexpr int kBM = 128;    // A rows per block
constexpr int kBN = 64;     // output columns per block (a block-row slice)
constexpr int kKW = 8;      // 4-byte K words per step (32 int8 values)
constexpr int kLd = 12;     // shared row stride in words, as in K2
constexpr int kThreads = 256;

struct BsrGeom {
  int64_t M;
  int K, N, bh, bw, nsub;   // nsub: kBN-column slices per block row
};

// kWhole: bw % 32 == 0, so every K step lies inside one block and its
// block bytes are one aligned 16-byte load a thread.
template <bool kWhole>
__global__ void __launch_bounds__(kThreads, 2)
bsr_int8_kernel(const int8_t* __restrict__ a,
                const int8_t* __restrict__ blocks,
                const int32_t* __restrict__ row_ptr,
                const int32_t* __restrict__ col_idx,
                const int32_t* __restrict__ bias,
                const float* __restrict__ factors, void* __restrict__ out,
                BsrGeom g, int relu, int requant, int vec_a) {
  __shared__ __align__(16) int As[2][kBM * kLd];   // [row][k word]
  __shared__ __align__(16) int Bs[2][kBN * kLd];   // [column][k word]

  const int br = blockIdx.y / g.nsub;
  const int c0 = (blockIdx.y % g.nsub) * kBN;  // slice start in the block row
  const int n0 = br * g.bh + c0;               // its first output column
  if (n0 >= g.N) return;                       // padding of N only

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int lo = row_ptr[br];
  const int per_block = kWhole ? g.bw / (4 * kKW)   // steps per stored block
                               : (g.bw + 4 * kKW - 1) / (4 * kKW);
  const int steps = (row_ptr[br + 1] - lo) * per_block;

  // Each thread fetches bytes [16*half, 16*half + 16) of every step for
  // one A row and, in the first half of the block, for one W row.
  const int half = tid % 2;
  const int row = tid / 2;                     // 0..127
  const bool a_live = m0 + row < g.M;
  const int8_t* arow = a + (a_live ? (m0 + row) * g.K : 0);
  const bool b_live = row < kBN && c0 + row < g.bh;

  int4 ra, rb;
  auto fetch = [&](int s) {
    ra = make_int4(0, 0, 0, 0);
    rb = make_int4(0, 0, 0, 0);
    const int blk = lo + s / per_block;
    const int kb = (s % per_block) * 4 * kKW + 16 * half;  // in the block
    const int k = col_idx[blk] * g.bw + kb;                // in A
    if constexpr (!kWhole) {
      const int n = min(16, g.bw - kb);        // its bytes inside the block
      if (n <= 0) return;
      // a whole 16-byte chunk at a 16-byte aligned address: one load
      const bool v16 = n == 16 && g.bw % 16 == 0;
      if (a_live && k < g.K)
        ra = v16 && vec_a ? __ldg(reinterpret_cast<const int4*>(arow + k))
                          : load16_masked(arow + k, min(n, g.K - k));
      if (b_live) {
        const int8_t* brow =
            blocks + (static_cast<int64_t>(blk) * g.bh + c0 + row) * g.bw +
            kb;
        rb = v16 ? __ldg(reinterpret_cast<const int4*>(brow))
                 : load16_masked(brow, n);
      }
      return;
    }
    if (a_live) {
      if (vec_a) {
        if (k < g.K) ra = __ldg(reinterpret_cast<const int4*>(arow + k));
      } else {
        int w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          int v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kk = k + 4 * q + j;
            v[j] = kk < g.K ? arow[kk] : 0;
          }
          w[q] = pack4(v[0], v[1], v[2], v[3]);
        }
        ra = make_int4(w[0], w[1], w[2], w[3]);
      }
    }
    if (b_live)
      rb = __ldg(reinterpret_cast<const int4*>(
          blocks + (static_cast<int64_t>(blk) * g.bh + c0 + row) * g.bw +
          kb));
  };
  auto stash = [&](int s) {
    *reinterpret_cast<int4*>(&As[s][row * kLd + 4 * half]) = ra;
    if (row < kBN) *reinterpret_cast<int4*>(&Bs[s][row * kLd + 4 * half]) = rb;
  };

  // Warp tile: rows wm..wm+31 (two m16), columns wn..wn+31 (four n8).
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int gq = lane / 4, tq = lane % 4;  // mma groupID, thread in group
  int acc[2][4][4] = {};

  if (steps > 0) {
    fetch(0);
    stash(0);
    __syncthreads();
  }
  int s = 0;
  for (int step = 0; step < steps; ++step) {
    const bool more = step + 1 < steps;
    if (more) fetch(step + 1);  // in flight while the tensor cores run
    const int* as = As[s];
    const int* bs = Bs[s];
    int af[2][4], bf[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wm + 16 * i + gq;
      af[i][0] = as[r * kLd + tq];
      af[i][1] = as[(r + 8) * kLd + tq];
      af[i][2] = as[r * kLd + tq + 4];
      af[i][3] = as[(r + 8) * kLd + tq + 4];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = wn + 8 * j + gq;
      bf[j][0] = bs[c * kLd + tq];
      bf[j][1] = bs[c * kLd + tq + 4];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j][0], bf[j][1]);
    if (more) {
      stash(s ^ 1);  // the other stage: nobody reads it this step
      __syncthreads();
      s ^= 1;
    }
  }

  // Epilogue: acc[i][j] holds rows (r, r + 8) x columns (c, c + 1).
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int cl = wn + 8 * j + 2 * tq + e;  // column in the slice
      const int gn = n0 + cl;
      if (c0 + cl >= g.bh || gn >= g.N) continue;
      const int b = bias != nullptr ? bias[gn] : 0;
      const float f = requant ? factors[gn] : 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int64_t gm = m0 + wm + 16 * i + gq + 8 * h;
          if (gm >= g.M) continue;
          int v = acc[i][j][2 * h + e] + b;
          if (relu) v = max(v, 0);
          const int64_t off = gm * g.N + gn;
          if (requant)
            static_cast<int8_t*>(out)[off] =
                static_cast<int8_t>(requant_i8(v, f));
          else
            static_cast<int32_t*>(out)[off] = v;
        }
    }
}

// The Hopper path at N tile ``bn`` in clusters of ``split``.
int bsr_sm90(const void* a, const void* blocks, const void* row_ptr,
             const void* col_idx, const void* bias, const void* factors,
             void* out, int64_t M, int64_t K, int64_t N, int64_t nbr,
             int64_t bh, int64_t bw, int64_t relu, int64_t requant,
             int64_t bn, int64_t split, int64_t nnz, cudaStream_t stream) {
  if (split < 1 || split > sm90::kMaxSplit || sm90::kBM % split ||
      (bh < N ? bh : N) > bn)
    return static_cast<int>(cudaErrorInvalidValue);
  sm90::Params p{};
  p.a = static_cast<const int8_t*>(a);
  p.w = static_cast<const int8_t*>(blocks);
  p.row_ptr = static_cast<const int32_t*>(row_ptr);
  p.col_idx = static_cast<const int32_t*>(col_idx);
  p.bias = static_cast<const int32_t*>(bias);
  p.factors = static_cast<const float*>(factors);
  p.out = out;
  p.M = static_cast<int>(M);
  p.N = static_cast<int>(N);
  p.K = static_cast<int>(K);
  p.bk = bw % 128 == 0 ? 128 : bw % 64 == 0 ? 64 : 32;
  p.layout = sm90::layout_of(p.bk);
  p.bh = static_cast<int>(bh);
  p.bw = static_cast<int>(bw);
  p.split = static_cast<int>(split);
  p.relu = static_cast<int>(relu);
  p.requant = static_cast<int>(requant);
  const int esize = requant ? 1 : 4;
  p.vec = sm90::store_width(N * esize, bh * esize, out);
  p.m_tiles = static_cast<int>((M + sm90::kBM - 1) / sm90::kBM);
  p.n_tiles = static_cast<int>(nbr);
  CUtensorMap map_a{}, map_w{};
  cudaError_t err = sm90::make_map(&map_a, a, K, M, p.bk, sm90::kBM,
                                   /*wide=*/false);
  // the stored blocks as [nnz * bh, bw]; with none, a map nothing reads
  if (err == cudaSuccess)
    err = nnz > 0
              ? sm90::make_map(&map_w, blocks, bw, nnz * bh, p.bk, bn, true)
              : sm90::make_map(&map_w, a, K, M, p.bk, bn, true);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a tile reaches past its block row unless it is the row's height, or
  // the row is the only one
  const bool whole = bn == bh || N <= bh;
  CUtensorMap map_out{};
  if (bn == 64) {
    err = sm90::make_out_map<64>(&map_out, p, whole);
    if (err == cudaSuccess)
      err = sm90::launch<64, true, true>(map_a, map_w, map_out, p, stream);
  } else if (bn == 128) {
    err = sm90::make_out_map<128>(&map_out, p, whole);
    if (err == cudaSuccess)
      err = sm90::launch<128, true, true>(map_a, map_w, map_out, p, stream);
  } else if (bn == 256) {
    err = sm90::make_out_map<256>(&map_out, p, whole);
    if (err == cudaSuccess)
      err = sm90::launch<256, true, true>(map_a, map_w, map_out, p, stream);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// ---- the small-block path ----------------------------------------------

constexpr int kSmallWin = 32;   // K bytes of a block's window: one k32 step
constexpr int kSmallBoxA = sm90::kBM * kSmallWin;  // an A box (4 KB)
constexpr int kSmallA = 2 * kSmallBoxA;            // a stage's two boxes
constexpr int kSmallW = 2 * 16 * kSmallWin;        // a stage's W box
constexpr int kSmallStages = 4;
constexpr int kSmallConsumers = 128;               // one warpgroup
constexpr int kSmallThreads = kSmallConsumers + 32;  // and the producer
constexpr int kSmallRing = kSmallStages * (kSmallA + kSmallW);
constexpr int kSmallLd = 16;                       // int32s a staged row
static_assert(sm90::kBM * kSmallLd * 4 <= kSmallRing,
              "the staged partial reuses the ring");
constexpr int kSmallSmem = 1024 + kSmallRing + 16 * kSmallStages;

// D[64, 16] += A[64, 32] . B[16, 32]^T, s8 x s8 -> s32, both operands in
// shared memory (register 4j + e: row 16 * warp + lane / 4 + 8 * (e / 2),
// column 8j + 2 * (lane % 4) + e % 2).
__device__ __forceinline__ void wgmma_n16(int (&d)[8], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

// One CTA a (128-row M tile, block row) -- a cluster of p.split CTAs along
// the row's stages where split > 1.  map_w: the stage images [n_stages *
// 32, 32]; p.row_ptr: the stages of each block row; p.col_idx: each
// stage's two block columns (int32 pairs, -1 for the zero block of an odd
// row).
__global__ void __launch_bounds__(kSmallThreads)
    bsr_small_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_w,
                     const sm90::Params p) {
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle atoms' grid
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t ring_a = base, ring_w = base + kSmallStages * kSmallA;
  const uint32_t full = base + kSmallRing, empty = full + 8 * kSmallStages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rank = blockIdx.x % p.split, tile = blockIdx.x / p.split;
  const int br = tile % p.n_tiles, m0 = (tile / p.n_tiles) * kBM;
  const int n0 = br * p.bh, ncols = min(p.bh, p.N - n0);
  const int s0 = p.row_ptr[br];
  int first, nsteps;
  split_share(p.row_ptr[br + 1] - s0, p.split, rank, first, nsteps);
  first += s0;
  const int2* cols = reinterpret_cast<const int2*>(p.col_idx);

  if (tid == 0) {
    for (int s = 0; s < kSmallStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kSmallConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kSmallConsumers / 32) {
    // ---- the producer: one lane issues every copy ----
    if (lane == 0 && nsteps > 0) {
      int stage = 0, phase = 0;
      int2 c = __ldg(cols + first);
      for (int s = 0; s < nsteps; ++s) {
        // the next stage's columns, in flight while this one waits
        const int2 next = s + 1 < nsteps ? __ldg(cols + first + s + 1) : c;
        const uint32_t bar = full + 8 * stage, a = ring_a + stage * kSmallA;
        mbar_wait(empty + 8 * stage, phase ^ 1);
        mbar_expect_tx(bar, kSmallW + (c.y >= 0 ? 2 : 1) * kSmallBoxA);
        // each block's 32-byte window of A, from the 16-byte boundary
        // below it
        const int x0 = c.x * p.bw, x1 = c.y * p.bw;
        tma_load(a, &map_a, x0 - x0 % 16, m0, bar);
        // the zero block of an odd row takes no A: what the box held
        // before is multiplied by its zeros
        if (c.y >= 0)
          tma_load(a + kSmallBoxA, &map_a, x1 - x1 % 16, m0, bar);
        tma_load(ring_w + stage * kSmallW, &map_w, 0, (first + s) * 32, bar);
        c = next;
        if (++stage == kSmallStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- the consumer warpgroup: rows 64h + 16 * warp + lane / 4 ----
    int acc[2][8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[0][i] = acc[1][i] = 0;
    int stage = 0, phase = 0, prev = 0;
    for (int s = 0; s < nsteps; ++s) {
      mbar_wait(full + 8 * stage, phase);
      const uint32_t a = ring_a + stage * kSmallA, w = ring_w + stage * kSmallW;
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      wgmma_fence();
      // block b: its A box (rows 64h.. of it for half h) and W rows 16b..
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          wgmma_n16(acc[h],
                    smem_desc(a + b * kSmallBoxA + h * 64 * kSmallWin,
                              kSmallWin, 3),
                    smem_desc(w + b * 16 * kSmallWin, kSmallWin, 3));
      wgmma_commit();
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      wgmma_wait<1>();  // the previous step's group has retired: free it
      if (s > 0 && lane == 0) mbar_arrive(empty + 8 * prev);
      prev = stage;
      if (++stage == kSmallStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    const int lq = lane % 4;
    if (p.split == 1) {
      // bias, ReLU, requant and plain stores of the block row's columns:
      // pairs where every pair's offset is even, else one by one
      const bool pairs = p.N % 2 == 0 && p.bh % 2 == 0;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = 8 * j + 2 * lq;
        if (c >= ncols) continue;
        const bool two = c + 1 < ncols;
        const Col col0 = col_at(p, n0 + c),
                  col1 = two ? col_at(p, n0 + c + 1) : Col{};
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int64_t gm = static_cast<int64_t>(m0) + 64 * h +
                               16 * warp + lane / 4 + 8 * r;
            if (gm >= p.M) continue;
            const int x0 = finish(p, acc[h][4 * j + 2 * r], col0);
            const int x1 = two ? finish(p, acc[h][4 * j + 2 * r + 1], col1)
                               : 0;
            const int64_t o = gm * p.N + n0 + c;
            if (p.requant) {
              int8_t* out = static_cast<int8_t*>(p.out) + o;
              if (two && pairs) {
                *reinterpret_cast<uint16_t*>(out) = static_cast<uint16_t>(
                    (x0 & 0xff) | ((x1 & 0xff) << 8));
              } else {
                out[0] = static_cast<int8_t>(x0);
                if (two) out[1] = static_cast<int8_t>(x1);
              }
            } else {
              int32_t* out = static_cast<int32_t*>(p.out) + o;
              if (two && pairs) {
                *reinterpret_cast<int2*>(out) = make_int2(x0, x1);
              } else {
                out[0] = x0;
                if (two) out[1] = x1;
              }
            }
          }
      }
    } else {
      // every wgmma of the warpgroup has read the ring: stage the partial
      // over it
      asm volatile("bar.sync 1, %0;" ::"n"(kSmallConsumers) : "memory");
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      int* st = reinterpret_cast<int*>(smem);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = 64 * h + 16 * warp + lane / 4 + 8 * r;
            *reinterpret_cast<int2*>(&st[row * kSmallLd + 8 * j + 2 * lq]) =
                make_int2(acc[h][4 * j + 2 * r], acc[h][4 * j + 2 * r + 1]);
          }
    }
  }
  if (p.split == 1) return;

  cluster_sync();  // every rank's partial is staged
  // This rank's rows, four columns a unit: the partials of every rank
  // added, then the epilogue, then one store a column.
  if (tid < kSmallConsumers) {
    const int* st = reinterpret_cast<const int*>(smem);
    const int rows = kBM / p.split;
    for (int u = tid; u < rows * 4; u += kSmallConsumers) {
      const int row = rank * rows + u / 4, c = (u % 4) * 4;
      const int64_t gm = static_cast<int64_t>(m0) + row;
      if (gm >= p.M || c >= ncols) continue;
      const int at = row * kSmallLd + c;
      int4 v = *reinterpret_cast<const int4*>(&st[at]);
      for (int q = 0; q < p.split; ++q) {
        if (q == rank) continue;
        const int4 t = ld_cluster(base + 4 * at, q);
        v.x += t.x;
        v.y += t.y;
        v.z += t.z;
        v.w += t.w;
      }
      const int x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (c + e >= ncols) break;
        const int y = finish(p, x[e], col_at(p, n0 + c + e));
        const int64_t o = gm * p.N + n0 + c + e;
        if (p.requant)
          static_cast<int8_t*>(p.out)[o] = static_cast<int8_t>(y);
        else
          static_cast<int32_t*>(p.out)[o] = y;
      }
    }
  }
  cluster_sync();  // no CTA leaves while another reads its partial
}

// The small-block path: one CTA a (M tile, block row), in clusters of
// ``split`` along the row's stages.
int bsr_small(const void* a, const void* stages, const void* stage_ptr,
              const void* stage_col, const void* bias, const void* factors,
              void* out, int64_t M, int64_t K, int64_t N, int64_t nbr,
              int64_t bh, int64_t bw, int64_t relu, int64_t requant,
              int64_t split, int64_t n_stages, cudaStream_t stream) {
  if (split < 1 || split > sm90::kMaxSplit || sm90::kBM % split ||
      bh > 16 || bw > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  sm90::Params p{};
  p.row_ptr = static_cast<const int32_t*>(stage_ptr);
  p.col_idx = static_cast<const int32_t*>(stage_col);
  p.bias = static_cast<const int32_t*>(bias);
  p.factors = static_cast<const float*>(factors);
  p.out = out;
  p.M = static_cast<int>(M);
  p.N = static_cast<int>(N);
  p.K = static_cast<int>(K);
  p.bh = static_cast<int>(bh);
  p.bw = static_cast<int>(bw);
  p.split = static_cast<int>(split);
  p.relu = static_cast<int>(relu);
  p.requant = static_cast<int>(requant);
  p.n_tiles = static_cast<int>(nbr);
  p.m_tiles = static_cast<int>((M + sm90::kBM - 1) / sm90::kBM);
  // A's boxes: 32 bytes x 128 rows; the stage images as [n_stages * 32,
  // 32], one stage a box; with no stage, a map nothing reads
  CUtensorMap map_a{}, map_w{};
  cudaError_t err = sm90::make_map(&map_a, a, K, M, kSmallWin, sm90::kBM,
                                   /*wide=*/false);
  if (err == cudaSuccess)
    err = n_stages > 0 ? sm90::make_map(&map_w, stages, kSmallWin,
                                        n_stages * 32, kSmallWin, 32, true)
                       : sm90::make_map(&map_w, a, K, M, kSmallWin, 32, true);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(
                         static_cast<int64_t>(p.m_tiles) * nbr * split),
                     1, 1);
  cfg.blockDim = dim3(kSmallThreads, 1, 1);
  cfg.dynamicSmemBytes = kSmallSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(split);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, bsr_small_kernel, map_a, map_w, p);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// path 1: the Hopper path at N tile ``bn`` in clusters of ``split``; path
// 2: the small-block path in clusters of ``split``, with blocks, row_ptr
// and col_idx carrying its stage images, stage pointers and stage columns;
// path 0: the mma.sync path (vec_a: A's rows take 16-byte loads).
extern "C" int bsr_matmul_launch(const void* a, const void* blocks,
                                 const void* row_ptr, const void* col_idx,
                                 const void* bias, const void* factors,
                                 void* out, int64_t M, int64_t K, int64_t N,
                                 int64_t nbr, int64_t bh, int64_t bw,
                                 int64_t relu, int64_t requant,
                                 int64_t vec_a, int64_t path, int64_t bn,
                                 int64_t split, int64_t nnz, void* stream) {
  if (path == 1)
    return bsr_sm90(a, blocks, row_ptr, col_idx, bias, factors, out, M, K,
                    N, nbr, bh, bw, relu, requant, bn, split, nnz,
                    static_cast<cudaStream_t>(stream));
  if (path == 2)
    return bsr_small(a, blocks, row_ptr, col_idx, bias, factors, out, M, K,
                     N, nbr, bh, bw, relu, requant, split, nnz,
                     static_cast<cudaStream_t>(stream));
  const int nsub = static_cast<int>((bh + kBN - 1) / kBN);
  const BsrGeom g{M, static_cast<int>(K), static_cast<int>(N),
                  static_cast<int>(bh), static_cast<int>(bw), nsub};
  const dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM),
                  static_cast<unsigned>(nbr * nsub));
  auto* kernel = (bw % 32 == 0) ? bsr_int8_kernel<true>
                                : bsr_int8_kernel<false>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(blocks),
      static_cast<const int32_t*>(row_ptr),
      static_cast<const int32_t*>(col_idx),
      static_cast<const int32_t*>(bias), static_cast<const float*>(factors),
      out, g, static_cast<int>(relu), static_cast<int>(requant),
      static_cast<int>(vec_a));
  return static_cast<int>(cudaGetLastError());
}
