// K3: dense int8 GEMM with a fused epilogue, on Hopper's TMA and wgmma.
//
// Replaces resnet_accel_tpu/ops/matmul_int8.py::_mm_resident_kernel (and
// its tiled sibling _mm_kernel), reached through matmul_int8.
//
// Computes C[M, N] = A[M, K] @ W^T for int8 A [M, K] and the weight W
// [N, K] (K-major: matmul_int8's b [K, N] is its transpose), + bias[N],
// optional ReLU on the int32 sum, then either the raw int32 result or the
// golden requant to int8 with per-column factors.  M, N and K may be
// ragged.  The main loop is sm90_gemm_s8.cuh's, walking every K tile.
//
// What bounds it on the H100: on the serving path it runs the fc layer,
// M 128 by K 512 or 2048 by N 1000: 0.13 to 0.52 G operations and at most
// 2.4 MB of operands, 0.3 to 0.8 us at the card's peaks.  So it is bound
// by latency: how many SMs take part, and how long each waits for its
// first bytes.  The design: 64-column N tiles (16 at N 1000, against 8 at
// 128), each CTA waiting for 24 KB stages; K split across a cluster of two
// only where each rank keeps more than 4 K tiles (K 2048: 16 tiles, 32
// CTAs), since a cluster launch costs 1-2 us more than a plain one.  The
// staged variant takes the shapes TMA refuses (K % 16 != 0, or a base off
// 16 bytes).

#include <cuda_runtime.h>

#include <cstdint>

#include "sm90_gemm_s8.cuh"

namespace {
constexpr int kBN = 64;  // output columns a CTA
}  // namespace

extern "C" int matmul_int8_launch(const void* a, const void* w,
                                  const void* bias, const void* factors,
                                  void* out, int64_t M, int64_t N, int64_t K,
                                  int64_t relu, int64_t requant, int64_t tma,
                                  int64_t split, void* stream) {
  using namespace sm90;
  if (split < 1 || split > kMaxSplit || kBM % split)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.a = static_cast<const int8_t*>(a);
  p.w = static_cast<const int8_t*>(w);
  p.bias = static_cast<const int32_t*>(bias);
  p.factors = static_cast<const float*>(factors);
  p.out = out;
  p.M = static_cast<int>(M);
  p.N = static_cast<int>(N);
  p.K = static_cast<int>(K);
  p.bk = kBK;
  p.layout = layout_of(kBK);
  p.k_tiles = static_cast<int>((K + kBK - 1) / kBK);
  p.split = static_cast<int>(split);
  p.relu = static_cast<int>(relu);
  p.requant = static_cast<int>(requant);
  const int esize = requant ? 1 : 4;
  p.vec = store_width(N * esize, kBN * esize, out);
  p.n_tiles = static_cast<int>((N + kBN - 1) / kBN);
  p.m_tiles = static_cast<int>((M + kBM - 1) / kBM);
  auto s = static_cast<cudaStream_t>(stream);
  CUtensorMap map_a{}, map_w{}, map_out{};
  cudaError_t err = make_out_map<kBN>(&map_out, p, true);
  if (err == cudaSuccess && !tma)
    err = launch<kBN, false, false>(map_a, map_w, map_out, p, s);
  if (err == cudaSuccess && tma) {
    err = make_map(&map_a, a, K, M, kBK, kBM, true);
    if (err == cudaSuccess) err = make_map(&map_w, w, K, N, kBK, kBN, true);
    if (err == cudaSuccess)
      err = launch<kBN, false, true>(map_a, map_w, map_out, p, s);
  }
  return static_cast<int>(err);
}

extern "C" const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
