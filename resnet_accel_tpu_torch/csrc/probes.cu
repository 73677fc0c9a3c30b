// Rate and ablation probes: the card's counterparts of the TPU experiments
// under tools/ that reach pl.pallas_call outside the package.  They are
// not on any serving path; resnet_accel_tpu_torch/probes.py launches and
// times them.
//
// - mma_rate_kernel (tools/dot_probe.py::bench_one, mosaic_probe.py::
//   bench_dot_shapes, stem_dot_probe.py::dot_kernel): chained int8 dots on
//   the tensor cores, mma.sync m16n8k32 as K2, K4 and K8 issue them, at a
//   block tile of M x 64 x K with its operands resident in shared memory.
//   Each warp owns 16 rows by the 64 columns and walks K in 32-value steps,
//   reading its fragments from shared memory as the kernels do; the tile's
//   product is repeated ``reps`` times into the same accumulators.  The
//   output is every block's C tile, reps x A @ B^T.
// - chain_kernel (stem_dot_probe.py::vpu_kernel): dependent chains of the
//   epilogue's scalar steps, four chains a thread, each step reading
//   another chain's last value: int32 ``v = max(v, u + c)`` (the pool's
//   max), or the f32 requant step ``clamp(rint(f * m), lo, hi)`` with
//   __fmul_rn and rintf (K7's and the requant epilogues' arithmetic).
// - stem_probe_kernel (stem_stage_probe.py::main, stem_ring_probe.py's
//   epilogue_cost and staging_cost): the stem's tensor-core tile
//   (stem_mma_tile.cuh), pooled on fp32 input as K1 runs it, with stages
//   knocked out at compile time (stem_mma::Mode).  Mode 0 is the full
//   tile, K1's own code under another name.
// - tma_box_kernel: one TMA tiled load of a 16-byte x 128-row box of an
//   int8 [M, K] map with no swizzle, at inner coordinate x -- the load K4's
//   small-block path could not use: on the H100 an x off 16 bytes faults
//   with an illegal instruction (PERF.md), so that path loads 32-byte
//   windows from the 16-byte boundary below each block.

#include <cuda_runtime.h>

#include <cstdint>

#include "mma_s8.cuh"
#include "sm90_gemm_s8.cuh"
#include "stem_mma_tile.cuh"

namespace {

constexpr int kN = 64;   // columns of the probe's dot tile

__global__ void mma_rate_kernel(const int8_t* __restrict__ a,
                                const int8_t* __restrict__ b, int M, int K,
                                int reps, int* __restrict__ out) {
  extern __shared__ __align__(16) int smem[];
  const int kw = K / 4;          // K words a row
  const int ld = kw + 4;         // padded row: conflict-free fragments
  int* As = smem;                // [M][ld]
  int* Bs = smem + M * ld;       // [kN][ld]
  const int* a32 = reinterpret_cast<const int*>(a);
  const int* b32 = reinterpret_cast<const int*>(b);
  for (int e = threadIdx.x; e < M * kw; e += blockDim.x)
    As[(e / kw) * ld + e % kw] = a32[e];
  for (int e = threadIdx.x; e < kN * kw; e += blockDim.x)
    Bs[(e / kw) * ld + e % kw] = b32[e];
  __syncthreads();

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gq = lane / 4, tq = lane % 4;
  const int r = 16 * warp + gq;
  int acc[kN / 8][4] = {};
  for (int rep = 0; rep < reps; ++rep) {
    for (int k = 0; k < kw; k += 8) {
      const int fa[4] = {As[r * ld + k + tq], As[(r + 8) * ld + k + tq],
                         As[r * ld + k + tq + 4],
                         As[(r + 8) * ld + k + tq + 4]};
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        const int c = 8 * j + gq;
        mma_s8(acc[j], fa, Bs[c * ld + k + tq], Bs[c * ld + k + tq + 4]);
      }
    }
  }
  int* o = out + static_cast<int64_t>(blockIdx.x) * M * kN;
#pragma unroll
  for (int j = 0; j < kN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      o[(r + 8 * h) * kN + 8 * j + 2 * tq] = acc[j][2 * h];
      o[(r + 8 * h) * kN + 8 * j + 2 * tq + 1] = acc[j][2 * h + 1];
    }
}

template <bool kFloat>
__global__ void chain_kernel(const int* __restrict__ x, int n, int c,
                             float m, float lo, float hi,
                             int* __restrict__ out) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if constexpr (kFloat) {
    float f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = static_cast<float>(x[4 * t + i]);
    for (int s = 0; s < n; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        f[i] = fminf(fmaxf(rintf(__fmul_rn(f[(i + 1) & 3], m)), lo), hi);
    out[t] = static_cast<int>(f[0]) + static_cast<int>(f[1]) +
             static_cast<int>(f[2]) + static_cast<int>(f[3]);
  } else {
    int v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = x[4 * t + i];
    for (int s = 0; s < n; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = max(v[i], v[(i + 1) & 3] + c);
    out[t] = v[0] + v[1] + v[2] + v[3];
  }
}

template <int kMode>
__global__ void __launch_bounds__(stem_mma::kThreads, stem_mma::kCtasPerSm)
stem_probe_kernel(const float* __restrict__ x, const int* __restrict__ wp,
                  const int32_t* __restrict__ bias,
                  const float* __restrict__ factors,
                  int8_t* __restrict__ out, int H, int W, int Hc, int Wc,
                  int Hp, int Wp, int tiles_w, int tiles_img, int tiles,
                  float scale, bool pairs) {
  stem_mma::stem_tile<float, true, kMode>(x, wp, bias, factors, out, H, W,
                                          Hc, Wc, Hp, Wp, tiles_w, tiles_img,
                                          tiles, scale, pairs);
}

constexpr int kBoxK = 16, kBoxM = 128;

// out [128, 16] = the box of ``map`` at (x, 0), through shared memory.
__global__ void tma_box_kernel(const __grid_constant__ CUtensorMap map,
                               int x, int8_t* __restrict__ out) {
  __shared__ __align__(128) int8_t box[kBoxK * kBoxM];
  __shared__ __align__(8) uint64_t bar;
  const uint32_t b = sm90::smem_u32(&bar);
  if (threadIdx.x == 0) {
    sm90::mbar_init(b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    sm90::mbar_expect_tx(b, kBoxK * kBoxM);
    sm90::tma_load(sm90::smem_u32(box), &map, x, 0, b);
  }
  __syncthreads();
  sm90::mbar_wait(b, 0);
  for (int i = threadIdx.x; i < kBoxK * kBoxM; i += blockDim.x)
    out[i] = box[i];
}

}  // namespace

// a [M, K] int8 (K % 16 == 0, a 16-byte aligned base); out [128, 16]: the
// TMA box of 16 bytes x 128 rows at inner coordinate x, no swizzle.
extern "C" int tma_box_launch(const void* a, void* out, int64_t M, int64_t K,
                              int64_t x, void* stream) {
  const sm90::EncodeTiled fn = sm90::encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(M)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t box[2] = {kBoxK, kBoxM}, elem[2] = {1, 1};
  CUtensorMap map{};
  if (fn(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(a), dims,
         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  tma_box_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<int>(x), static_cast<int8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// a [M, K], b [64, K] int8 (K % 32 == 0, M 64 or 128); out [blocks, M, 64]
// int32.
extern "C" int mma_rate_launch(const void* a, const void* b, void* out,
                               int64_t M, int64_t K, int64_t reps,
                               int64_t blocks, void* stream) {
  const size_t smem = sizeof(int) * (M + kN) * (K / 4 + 4);
  cudaError_t err = cudaFuncSetAttribute(
      mma_rate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  mma_rate_kernel<<<static_cast<unsigned>(blocks),
                    static_cast<unsigned>(2 * M), smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<int>(M), static_cast<int>(K), static_cast<int>(reps),
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// x [threads * 4] int32 (the chains' start), out [threads] int32; kind 0
// the int32 max chain (c), 1 the f32 requant chain (m, lo, hi).
extern "C" int chain_launch(const void* x, void* out, int64_t threads,
                            int64_t n, int64_t kind, int64_t c, float m,
                            float lo, float hi, void* stream) {
  constexpr int kBlock = 256;
  const unsigned grid = static_cast<unsigned>(threads / kBlock);
  auto s = static_cast<cudaStream_t>(stream);
  if (kind == 1)
    chain_kernel<true><<<grid, kBlock, 0, s>>>(
        static_cast<const int*>(x), static_cast<int>(n), static_cast<int>(c),
        m, lo, hi, static_cast<int*>(out));
  else
    chain_kernel<false><<<grid, kBlock, 0, s>>>(
        static_cast<const int*>(x), static_cast<int>(n), static_cast<int>(c),
        m, lo, hi, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// K1's launch with a stage mode (stem_mma::Mode): wp the packed [64, 192]
// weight, ctas as stem_fused_launch takes them.
extern "C" int stem_probe_launch(const void* x, const void* wp,
                                 const void* bias, const void* factors,
                                 void* out, int64_t N, int64_t H, int64_t W,
                                 int64_t Hp, int64_t Wp, int64_t ctas,
                                 float scale, int64_t mode, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case stem_mma::kFull:
      return stem_mma::launch<true>(stem_probe_kernel<stem_mma::kFull>, x, wp,
                                    bias, factors, out, N, H, W, Hp, Wp, ctas,
                                    scale, false, s);
    case stem_mma::kStageOnly:
      return stem_mma::launch<true>(stem_probe_kernel<stem_mma::kStageOnly>,
                                    x, wp, bias, factors, out, N, H, W, Hp,
                                    Wp, ctas, scale, false, s);
    case stem_mma::kNoLoads:
      return stem_mma::launch<true>(stem_probe_kernel<stem_mma::kNoLoads>, x,
                                    wp, bias, factors, out, N, H, W, Hp, Wp,
                                    ctas, scale, false, s);
    case stem_mma::kNoPool:
      return stem_mma::launch<true>(stem_probe_kernel<stem_mma::kNoPool>, x,
                                    wp, bias, factors, out, N, H, W, Hp, Wp,
                                    ctas, scale, false, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
