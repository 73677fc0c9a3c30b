// K3: dense int8 GEMM with a fused epilogue.
//
// Replaces resnet_accel_tpu/ops/matmul_int8.py::_mm_resident_kernel (and
// its tiled sibling _mm_kernel), reached through matmul_int8.
//
// Computes C[M,N] = A[M,K] @ B[K,N] (int8 x int8 -> int32), + bias[N],
// optional ReLU on the int32 sum, then either the raw int32 result or the
// golden requant to int8 with per-column factors.  M, N and K may be
// ragged: every load and store is masked in the kernel.
//
// What bounds it on the H100: on the serving path it runs the fc layer,
// 128 x 512 @ 512 x 1000 -- 65 M multiply-adds and under 1 MB of operands,
// so the launch and one pass over B bound it, not arithmetic.  The design
// answers that with one launch and a 64 x 64 output tile per block, each
// thread holding a 4 x 4 register tile, K consumed 32 bytes at a time
// through shared memory as packed 4-byte words fed to __dp4a.  Operands
// are read a byte at a time so that any K (not only multiples of 4) and
// any alignment are taken.  Tensor-core mma is a later change.

#include <cuda_runtime.h>

#include <cstdint>

#include "epilogue.cuh"

namespace {

constexpr int kTM = 64;   // output rows per block
constexpr int kTN = 64;   // output columns per block
constexpr int kTKW = 8;   // 4-byte K words per step (32 K values)
constexpr int kPad = 4;   // keeps rows 16-byte aligned, spreads banks

__global__ void __launch_bounds__(256)
mm_int8_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
               const int32_t* __restrict__ bias,
               const float* __restrict__ factors, void* __restrict__ out,
               int M, int N, int K, int relu, int requant) {
  __shared__ __align__(16) int As[kTKW][kTM + kPad];
  __shared__ __align__(16) int Bs[kTKW][kTN + kPad];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * kTM, n0 = blockIdx.y * kTN;
  int acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += 4 * kTKW) {
    for (int e = tid; e < kTM * kTKW; e += blockDim.x) {
      const int w = e % kTKW, m = e / kTKW;
      const int gm = m0 + m, gk = k0 + 4 * w;
      int v[4] = {0, 0, 0, 0};
      if (gm < M) {
        const int8_t* row = a + static_cast<int64_t>(gm) * K;
        for (int j = 0; j < 4; ++j)
          if (gk + j < K) v[j] = row[gk + j];
      }
      As[w][m] = pack4(v[0], v[1], v[2], v[3]);
    }
    for (int e = tid; e < kTN * kTKW; e += blockDim.x) {
      const int n = e % kTN, w = e / kTN;  // n fastest: coalesced rows of B
      const int gn = n0 + n, gk = k0 + 4 * w;
      int v[4] = {0, 0, 0, 0};
      if (gn < N)
        for (int j = 0; j < 4; ++j)
          if (gk + j < K) v[j] = b[static_cast<int64_t>(gk + j) * N + gn];
      Bs[w][n] = pack4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kTKW; ++w) {
      const int4 av = *reinterpret_cast<const int4*>(&As[w][ty * 4]);
      const int4 bv = *reinterpret_cast<const int4*>(&Bs[w][tx * 4]);
      const int ar[4] = {av.x, av.y, av.z, av.w};
      const int br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn >= N) continue;
      int v = acc[i][j] + (bias != nullptr ? bias[gn] : 0);
      if (relu) v = max(v, 0);
      const int64_t o = static_cast<int64_t>(gm) * N + gn;
      if (requant)
        static_cast<int8_t*>(out)[o] =
            static_cast<int8_t>(requant_i8(v, factors[gn]));
      else
        static_cast<int32_t*>(out)[o] = v;
    }
  }
}

}  // namespace

extern "C" int matmul_int8_launch(const void* a, const void* b,
                                  const void* bias, const void* factors,
                                  void* out, int64_t M, int64_t N, int64_t K,
                                  int64_t relu, int64_t requant,
                                  void* stream) {
  const dim3 grid(static_cast<unsigned>((M + kTM - 1) / kTM),
                  static_cast<unsigned>((N + kTN - 1) / kTN));
  mm_int8_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<const int32_t*>(bias), static_cast<const float*>(factors),
      out, static_cast<int>(M), static_cast<int>(N), static_cast<int>(K),
      static_cast<int>(relu), static_cast<int>(requant));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
