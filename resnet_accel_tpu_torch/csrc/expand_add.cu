// K7: a bottleneck block's 1x1 expand conv and its residual join in one
// pass -- an int8 GEMM on the tensor cores with the requant and the join
// fused into its epilogue.
//
// Replaces resnet_accel_tpu/ops/expand_fused.py::_kernel (reached through
// expand_add_int8): the c3 of every bottleneck block of ResNet-50/101/152.
//
// Layout: a 1x1 stride-1 conv on channels-last activations is a plain
// GEMM.  A = x viewed [M = N*H*W, C_in] row-major, B = w [C_out, C_in]
// (K-contiguous rows), and the residual and the output are [M, C_out]
// row-major: no taps, no halo, no padding.  C_in and C_out must be
// multiples of 4; M is any size.
//
// Per output (pixel p, channel o):
//   acc = sum_c x[p, c] * w[o, c] + bias[o]                (int32, exact)
//   y   = clip(rint(float(acc) * factors[o]), -128, 127)    (no ReLU)
//   out = max(clip(rint((y*s_main + r[p,o]*s_res) / s_out), -128, 127), 0)
//
// What bounds it on the H100: over the 16 c3 of ResNet-50 at batch 128 it
// computes 105 G multiply-adds (210 G ops) and moves 1.59 GB -- the c2
// output in, the residual in, the output out, each once.  That is 132 ops
// a byte, far under the card's int8 ridge of about 590 (1,979 TOP/s over
// 3.35 TB/s): by its bytes it is bound by memory, with a floor near
// 0.47 ms; the residual read and the output write are two thirds of them.
// Measured, the exact f32 epilogue (three int-to-float conversions, two
// roundings and an IEEE divide for each of 707 M outputs) takes about half
// of its time, and the loads and stores, which one block does not overlap
// when K is short, most of the rest (PERF.md).  The design answers the
// bytes by moving every byte once, 16 bytes at a time:
// cp.async brings A and B slices through a 3-stage ring in shared memory
// and the block's whole residual tile beside them (in flight behind the K
// loop); the product runs on mma.sync m16n8k32 (the step shared with K2);
// the epilogue joins in shared memory, over the residual tile, and the
// block then stores its int8 output tile as 16-byte rows.  A block owns
// 128 pixels x 128 channels (8 warps of 64 x 32); every c3 of the family
// has C_out = 4 * C_in >= 256, so the tile wastes nothing.  The N tiles of
// one M tile are neighbours in the grid, so A's second read hits L2.
// When C_in or C_out is not a multiple of 16 the same kernel copies 4-byte
// words instead.  wgmma, TMA and a persistent schedule are the next steps.

#include <cuda_runtime.h>

#include <cstdint>

#include "epilogue.cuh"
#include "mma_s8.cuh"

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

// Copy kBytes (16 or 4) from global to shared memory asynchronously; with
// !valid nothing is read and the bytes are zero-filled.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? kBytes : 0;
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(gmem), "r"(n) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(gmem), "r"(n) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// kChunk: the bytes one copy moves, 16 when C_in, C_out and every pointer
// allow it, else 4.  Each chunk lies wholly inside or wholly outside the
// matrix (C_in and C_out are multiples of kChunk), so masking is per chunk.
template <int kChunk>
__global__ void __launch_bounds__(kThreads, 2)
expand_add_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                  const int32_t* __restrict__ bias,
                  const float* __restrict__ factors,
                  const int8_t* __restrict__ res, int8_t* __restrict__ out,
                  int64_t M, int Cin, int Cout, float s_main, float s_res,
                  float s_out) {
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
    cp_async<kChunk>(tile + r * kLdT + c, ok ? res + gm * Cout + n0 + c : res,
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
      cp_async<kChunk>(as + r * kLd * 4 + c, ok ? x + gm * Cin + k0 + c : x,
                       ok);
    }
    for (int idx = tid; idx < kBN * kRowChunks; idx += kThreads) {
      const int r = idx / kRowChunks, c = (idx % kRowChunks) * kChunk;
      const bool ok = n0 + r < Cout && k0 + c < Cin;
      cp_async<kChunk>(
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
        const int q0 = residual_join(y0, r.x, s_main, s_res, s_out);
        const int q1 = residual_join(y1, r.y, s_main, s_res, s_out);
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
    if constexpr (kChunk == 16) {
      *reinterpret_cast<int4*>(out + gm * Cout + n0 + c) =
          *reinterpret_cast<const int4*>(tile + r * kLdT + c);
    } else {
      *reinterpret_cast<int*>(out + gm * Cout + n0 + c) =
          *reinterpret_cast<const int*>(tile + r * kLdT + c);
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" int expand_add_launch(const void* x, const void* w,
                                 const void* bias, const void* factors,
                                 const void* res, void* out, int64_t M,
                                 int64_t Cin, int64_t Cout, float s_main,
                                 float s_res, float s_out, void* stream) {
  const bool vec = Cin % 16 == 0 && Cout % 16 == 0 && aligned16(x) &&
                   aligned16(w) && aligned16(res) && aligned16(out);
  auto* kernel = vec ? expand_add_kernel<16> : expand_add_kernel<4>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (M + kBM - 1) / kBM * ((Cout + kBN - 1) / kBN);
  kernel<<<static_cast<unsigned>(blocks), kThreads, kSmemBytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const int32_t*>(bias), static_cast<const float*>(factors),
      static_cast<const int8_t*>(res), static_cast<int8_t*>(out), M,
      static_cast<int>(Cin), static_cast<int>(Cout), s_main, s_res, s_out);
  return static_cast<int>(cudaGetLastError());
}
