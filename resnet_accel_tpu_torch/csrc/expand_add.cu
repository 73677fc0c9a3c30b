// K7: a bottleneck block's 1x1 expand conv and its residual join in one
// pass -- an int8 GEMM on the tensor cores with the requant and the join
// fused into its epilogue.
//
// Replaces resnet_accel_tpu/ops/expand_fused.py::_kernel (reached through
// expand_add_int8): the c3 of every bottleneck block of ResNet-50/101/152.
//
// Layout: a 1x1 stride-1 conv on channels-last activations is a plain
// GEMM.  A = x viewed [M = N*H*W, C_in] row-major, W = w [C_out, C_in]
// (K-contiguous rows), and the residual and the output are [M, C_out]
// row-major: no taps, no halo, no padding.
//
// Per output (pixel p, channel o):
//   acc = sum_c x[p, c] * w[o, c] + bias[o]                (int32, exact)
//   z   = clip(rint(float(acc) * factors[o]), -128, 127)    (no ReLU)
//   out = max(clip(rint((z*s_main + r[p,o]*s_res) / s_out), -128, 127), 0)
// where the JAX kernel's inv_out is given (exact_inv_out_scale's proof for
// the block's scales), "* inv_out" in place of "/ s_out": the same bits.
//
// What bounds it on the H100: over the 16 c3 of ResNet-50 at batch 128 it
// computes 105 G multiply-adds (210 G ops) and moves 1.59 GB -- the c2
// output in, the residual in, the output out, each once.  That is 132 ops
// a byte, far under the card's int8 ridge of about 590 (1,979 TOP/s over
// 3.35 TB/s): it is bound by its bytes, 0.476 ms, two thirds of them the
// residual read and the output write.  Its epilogue is as long as its
// product: about 20 instructions an output (707 M outputs), so it has to
// run while the next tile's bytes arrive, and it cannot afford the
// quarter-rate conversions (float to int, round) the golden's steps name.
//
// Two routes, chosen by the host (ops/expand_fused.py::expand_plan) and
// counted as variants:
//
// - wgmma_tma (C_in and C_out multiples of 16, x, w, residual and output
//   16-byte aligned, bias and factors 8-byte aligned: every c3 of the
//   family): sm90_gemm_s8.cuh's main
//   loop in K7's mode (kExpand), the dense walk K3 takes: TMA tiled maps
//   over A and W, a ring of stages fed by one producer warp, two consumer
//   warpgroups on wgmma.m64nBNk32, persistent CTAs walking 128 x BN tiles
//   N tile fastest, so the producer loads the next tile while the
//   consumers join this one and the CTAs at work share A in L2.  The
//   accumulator starts at the bias.  The residual comes as TMA boxes
//   (128 bytes by 128 rows, 128-byte swizzle) into one of two tile
//   buffers in shared memory: consumer thread 0 loads the next tile's as
//   this tile's epilogue starts, so it arrives behind a whole epilogue.
//   The epilogue (join_tile) works in the accumulator fragment's layout
//   -- each lane's column pair of two rows: requant from the fragment,
//   the residual pair read from the buffer, the join, the output pair
//   written back over it, no bank conflicts -- and the tile leaves by TMA
//   store from the buffer.  Every rounding is
//   an exact add of 1.5 * 2^23 after a clamp (sm90_gemm_s8.cuh, kRound),
//   not a conversion; the join divides by s_out with __fdiv_rn, or
//   multiplies by the proven reciprocal (kExpandInv) where the host has
//   the proof.  Tiles are 128 x 128 at two CTAs an SM: on the H100 BN
//   256 (one CTA an SM) and BN 64 (three) were slower at every c3 of
//   ResNet-50 (PERF.md).  A first design of this route
//   joined in registers after a quad transpose, with the residual loaded
//   and the output stored 8 bytes a lane, and ran 2.3x slower (PERF.md).
// - mma_sync (any other C_in, C_out multiple of 4 with 4-byte aligned
//   bases; no ResNet c3 takes it): the kernel below, one block per
//   128 x 128 tile, a cp.async ring of 4-byte copies, mma.sync m16n8k32,
//   the residual tile fetched behind the K loop and joined in shared
//   memory, with the same two joins (residual_join, residual_join_inv).

#include <cuda_runtime.h>

#include <cstdint>

#include "epilogue.cuh"
#include "mma_s8.cuh"
#include "sm90_gemm_s8.cuh"

namespace {

constexpr int kBM = 128;          // output pixels per block
constexpr int kBN = 128;          // output channels per block
constexpr int kBK = 64;           // K bytes per ring stage: two mma k32 steps
constexpr int kStages = 3;
constexpr int kLd = kBK / 4 + 4;  // ring row stride in words (20):
                                  // conflict-free fragment reads,
                                  // 16-byte aligned rows
constexpr int kLdT = kBN + 16;    // residual/output tile row stride, bytes
constexpr int kThreads = 256;
constexpr int kStageWords = (kBM + kBN) * kLd;
constexpr int kSmemBytes = kStages * kStageWords * 4 + kBM * kLdT;

// Copy 4 bytes from global to shared memory asynchronously; with !valid
// nothing is read and the bytes are zero-filled.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// Every copy moves kChunk bytes.  Each chunk lies wholly inside or wholly
// outside the matrix (C_in and C_out are multiples of 4), so masking is per
// chunk.  kInv: s_join is the proven reciprocal inv_out and the join
// multiplies by it (residual_join_inv); else s_join is s_out and the join
// divides.
constexpr int kChunk = 4;

template <bool kInv>
__global__ void __launch_bounds__(kThreads, 2)
expand_add_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                  const int32_t* __restrict__ bias,
                  const float* __restrict__ factors,
                  const int8_t* __restrict__ res, int8_t* __restrict__ out,
                  int64_t M, int Cin, int Cout, float s_main, float s_res,
                  float s_join) {
  extern __shared__ __align__(16) int smem[];
  int* ring = smem;  // kStages x {A [kBM][kLd], B [kBN][kLd]} words
  int8_t* tile = reinterpret_cast<int8_t*>(smem + kStages * kStageWords);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n_tiles = (Cout + kBN - 1) / kBN;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x / n_tiles) * kBM;
  const int n0 = static_cast<int>(blockIdx.x % n_tiles) * kBN;
  const int Kt = (Cin + kBK - 1) / kBK;

  // The residual tile [kBM][kBN] first: it is not needed before the
  // epilogue, so it stays in flight behind the whole K loop.
  constexpr int kTileChunks = kBN / kChunk;
  for (int idx = tid; idx < kBM * kTileChunks; idx += kThreads) {
    const int r = idx / kTileChunks, c = (idx % kTileChunks) * kChunk;
    const int64_t gm = m0 + r;
    const bool ok = gm < M && n0 + c < Cout;
    cp_async4(tile + r * kLdT + c, ok ? res + gm * Cout + n0 + c : res,
                     ok);
  }
  cp_async_commit();

  // load(kt, s): K slice kt of A's and B's tile rows into ring stage s.
  constexpr int kRowChunks = kBK / kChunk;
  auto load = [&](int kt, int s) {
    int8_t* as = reinterpret_cast<int8_t*>(ring + s * kStageWords);
    int8_t* bs = as + kBM * kLd * 4;
    const int k0 = kt * kBK;
    for (int idx = tid; idx < kBM * kRowChunks; idx += kThreads) {
      const int r = idx / kRowChunks, c = (idx % kRowChunks) * kChunk;
      const int64_t gm = m0 + r;
      const bool ok = gm < M && k0 + c < Cin;
      cp_async4(as + r * kLd * 4 + c, ok ? x + gm * Cin + k0 + c : x,
                       ok);
    }
    for (int idx = tid; idx < kBN * kRowChunks; idx += kThreads) {
      const int r = idx / kRowChunks, c = (idx % kRowChunks) * kChunk;
      const bool ok = n0 + r < Cout && k0 + c < Cin;
      cp_async4(
          bs + r * kLd * 4 + c,
          ok ? w + static_cast<int64_t>(n0 + r) * Cin + k0 + c : w, ok);
    }
  };

  // Warp tile: rows wm..wm+63 (four m16), cols wn..wn+31 (four n8).
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  const int gq = lane / 4, tq = lane % 4;  // mma groupID, thread in group
  int acc[4][4][4] = {};

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < Kt) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < Kt; ++kt) {
    cp_async_wait<kStages - 2>();  // slice kt (and the residual) arrived
    __syncthreads();
    // Refill the stage that slice kt - 1 used: every warp is past it.
    const int next = kt + kStages - 1;
    if (next < Kt) load(next, next % kStages);
    cp_async_commit();
    const int* as = ring + (kt % kStages) * kStageWords;
    const int* bs = as + kBM * kLd;
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk) {
      int a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm + 16 * i + gq;
        a[i][0] = as[r * kLd + 8 * kk + tq];
        a[i][1] = as[(r + 8) * kLd + 8 * kk + tq];
        a[i][2] = as[r * kLd + 8 * kk + tq + 4];
        a[i][3] = as[(r + 8) * kLd + 8 * kk + tq + 4];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wn + 8 * j + gq;
        b[j][0] = bs[c * kLd + 8 * kk + tq];
        b[j][1] = bs[c * kLd + 8 * kk + tq + 4];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // Epilogue: acc[i][j] holds rows (r, r + 8) x cols (c, c + 1); each
  // output replaces its residual byte in the tile.
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = wn + 8 * j + 2 * tq;
    if (n0 + c >= Cout) continue;  // Cout % 4 == 0: both columns or neither
    const int b0 = bias[n0 + c], b1 = bias[n0 + c + 1];
    const float f0 = factors[n0 + c], f1 = factors[n0 + c + 1];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        char2* t = reinterpret_cast<char2*>(
            tile + (wm + 16 * i + gq + 8 * h) * kLdT + c);
        const char2 r = *t;
        const int y0 = requant_i8(acc[i][j][2 * h] + b0, f0);
        const int y1 = requant_i8(acc[i][j][2 * h + 1] + b1, f1);
        const int q0 = kInv ? residual_join_inv(y0, r.x, s_main, s_res, s_join)
                            : residual_join(y0, r.x, s_main, s_res, s_join);
        const int q1 = kInv ? residual_join_inv(y1, r.y, s_main, s_res, s_join)
                            : residual_join(y1, r.y, s_main, s_res, s_join);
        *t = make_char2(static_cast<signed char>(q0),
                        static_cast<signed char>(q1));
      }
  }
  __syncthreads();

  // The output tile, kChunk bytes a thread, rows past M left out.
  for (int idx = tid; idx < kBM * kTileChunks; idx += kThreads) {
    const int r = idx / kTileChunks, c = (idx % kTileChunks) * kChunk;
    const int64_t gm = m0 + r;
    if (gm >= M || n0 + c >= Cout) continue;
    *reinterpret_cast<int*>(out + gm * Cout + n0 + c) =
        *reinterpret_cast<const int*>(tile + r * kLdT + c);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

cudaError_t launch_mma_sync(const void* x, const void* w, const void* bias,
                            const void* factors, const void* res, void* out,
                            int64_t M, int64_t Cin, int64_t Cout, bool inv,
                            float s_main, float s_res, float s_join,
                            cudaStream_t stream) {
  auto* kernel = inv ? expand_add_kernel<true> : expand_add_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (M + kBM - 1) / kBM * ((Cout + kBN - 1) / kBN);
  kernel<<<static_cast<unsigned>(blocks), kThreads, kSmemBytes, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const int32_t*>(bias), static_cast<const float*>(factors),
      static_cast<const int8_t*>(res), static_cast<int8_t*>(out), M,
      static_cast<int>(Cin), static_cast<int>(Cout), s_main, s_res, s_join);
  return cudaGetLastError();
}

// The Hopper route: A [M, K] and W [N, K] through tiled maps of bk-byte K
// boxes; the residual and the output through maps of 128-byte boxes by
// 128 rows.
cudaError_t launch_sm90(sm90::Params& p, bool inv, cudaStream_t stream) {
  constexpr int BN = 128;
  CUtensorMap map_a{}, map_w{}, map_out{}, map_res{};
  p.n_tiles = (p.N + BN - 1) / BN;
  cudaError_t err = sm90::make_map(&map_a, p.a, p.K, p.M, p.bk, sm90::kBM,
                                   true);
  if (err == cudaSuccess)
    err = sm90::make_map(&map_w, p.w, p.K, p.N, p.bk, BN, true);
  if (err == cudaSuccess)
    err = sm90::make_map(&map_out, p.out, p.N, p.M, 128, sm90::kBM, true);
  if (err == cudaSuccess)
    err = sm90::make_map(&map_res, p.res, p.N, p.M, 128, sm90::kBM, true);
  if (err != cudaSuccess) return err;
  return inv ? sm90::launch<BN, false, true, false, sm90::kExpandInv>(
                   map_a, map_w, map_out, p, stream, map_res)
             : sm90::launch<BN, false, true, false, sm90::kExpandDiv>(
                   map_a, map_w, map_out, p, stream, map_res);
}

}  // namespace

// The route follows ops/expand_fused.py::expand_plan: bn 128 takes the
// Hopper route and refuses what it does not take (C_in or C_out off a
// multiple of 16, a base off 16 bytes, bias or factors off 8); bn 0 takes
// the mma.sync kernel (C_in, C_out multiples of 4).  inv: join by the
// multiply by inv_out (the host holds the proof), else by the divide.
extern "C" int expand_add_launch(const void* x, const void* w,
                                 const void* bias, const void* factors,
                                 const void* res, void* out, int64_t M,
                                 int64_t Cin, int64_t Cout, int64_t bn,
                                 int64_t inv, float s_main, float s_res,
                                 float s_out, float inv_out, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (bn == 0)
    return static_cast<int>(launch_mma_sync(x, w, bias, factors, res, out, M,
                                            Cin, Cout, inv, s_main, s_res,
                                            inv ? inv_out : s_out, st));
  const bool aligned = aligned16(x) && aligned16(w) && aligned16(res) &&
                       aligned16(out);
  const bool aligned8 = reinterpret_cast<uintptr_t>(bias) % 8 == 0 &&
                        reinterpret_cast<uintptr_t>(factors) % 8 == 0;
  if (Cin % 16 || Cout % 16 || !aligned || !aligned8 || M > INT32_MAX ||
      Cin > INT32_MAX || Cout > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  sm90::Params p{};
  p.a = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.bias = static_cast<const int32_t*>(bias);
  p.factors = static_cast<const float*>(factors);
  p.out = out;
  p.M = static_cast<int>(M);
  p.N = static_cast<int>(Cout);
  p.K = static_cast<int>(Cin);
  p.bk = Cin % 128 == 0 ? 128 : Cin % 64 == 0 ? 64 : 32;
  p.layout = sm90::layout_of(p.bk);
  p.k_tiles = (p.K + p.bk - 1) / p.bk;
  p.split = 1;
  p.requant = 1;
  p.tma_out = 1;  // the tiles leave by TMA store
  p.m_tiles = static_cast<int>((M + sm90::kBM - 1) / sm90::kBM);
  p.res = static_cast<const int8_t*>(res);
  p.s_main = s_main;
  p.s_res = s_res;
  p.s_out = s_out;
  p.inv_out = inv_out;
  if (bn != 128) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_sm90(p, inv != 0, st));
}
