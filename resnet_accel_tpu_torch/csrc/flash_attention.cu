// K5: attention with an online softmax, float32.
//
// Replaces resnet_accel_tpu/ops/flash_attention.py::_fa_kernel, reached
// through flash_attention from the LM's prefill
// (TransformerBlockInt8._forward_kv with flash=True).
//
// Computes, for q, k, v float32 [BH, T, dh] and each row t of each head,
//   o[t] = softmax_j(q[t] . k[j] * scale) @ v
// over the visible keys j: j < T, and j <= t when causal.  A row with no
// visible key gives 0.  The [T, T] scores never reach device memory: each
// block carries the running max m, the running sum l and the output
// accumulator across the key tiles, as the TPU kernel carries them across
// its grid's k dimension.
//
// What bounds it on the H100: at the LM's prefill (BH = 8 heads, T = 640,
// dh = 64, causal) one launch needs 4 * BH * dh * T(T+1)/2 = 0.42 GFLOP of
// float32 multiply-adds (6.3 us at the 67 TFLOP/s FFMA peak) and moves 5.2
// MB (1.6 us at 3.35 TB/s): operations bound it.  This first version is
// simple and right, not fast: every multiply-add reads one operand from
// shared memory, so shared-memory bandwidth holds it well below the FFMA
// peak, and at BH = 8 its 80 blocks leave SMs idle.  wgmma, TMA and a
// split over the keys are later work.
//
// Design: one block of 256 threads per (head, 64-row q tile).  The q tile
// and each 64-row K and V tile are staged in shared memory, rows padded to
// dh + 1 floats so that the four threads of a row, and neighbouring rows,
// fall on distinct banks.  Four threads own one q row: each computes the
// scores of 16 of the tile's 64 keys and owns every fourth output column,
// so m, l and the accumulator stay in registers; the row's four threads
// share their row max and sum through warp shuffles, and each p value is
// broadcast to them by a shuffle for the p @ V product.  Key tiles above
// the diagonal are not visited when causal; keys at or past T are masked
// and q rows past T are not stored.  Products are __fmaf_rn in float32 (the
// TPU kernel runs its dots at HIGHEST precision: no TF32 here either),
// exponentials are expf, and the build's -fmad=false keeps every other
// multiply and add separately rounded.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kRows = 64;                  // q rows per block; keys per tile
constexpr int kLanes = 4;                  // threads per q row
constexpr int kThreads = kRows * kLanes;   // 256
constexpr int kKeys = kRows / kLanes;      // keys of a tile per thread
constexpr unsigned kFull = 0xffffffffu;

// NC: output columns per thread, dh <= kLanes * NC.
template <int NC>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int T, int dh, int causal, float scale) {
  extern __shared__ float smem[];
  const int ld = dh + 1;
  float* qs = smem;                 // [kRows][ld]
  float* ks = qs + kRows * ld;      // [kRows][ld]
  float* vs = ks + kRows * ld;      // [kRows][ld]

  const int tid = threadIdx.x;
  const int r = tid / kLanes;                  // q row within the tile
  const int c = tid % kLanes;                  // thread within the row
  const int row_lane0 = (tid % 32) & ~(kLanes - 1);
  const int q0 = blockIdx.x * kRows;
  const int qpos = q0 + r;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * T * dh;

  for (int e = tid; e < kRows * dh; e += kThreads) {
    const int i = e / dh, d = e % dh;
    const int t = q0 + i;
    qs[i * ld + d] = t < T ? q[base + static_cast<int64_t>(t) * dh + d] : 0.f;
  }

  float m = -INFINITY, l = 0.f;
  float acc[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) acc[j] = 0.f;

  const int n_tiles = (T + kRows - 1) / kRows;
  const int n_visit = causal ? min(n_tiles, static_cast<int>(blockIdx.x) + 1)
                             : n_tiles;
  for (int kt = 0; kt < n_visit; ++kt) {
    const int k0 = kt * kRows;
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < kRows * dh; e += kThreads) {
      const int i = e / dh, d = e % dh;
      const int t = k0 + i;
      const int64_t g = base + static_cast<int64_t>(t) * dh + d;
      ks[i * ld + d] = t < T ? k[g] : 0.f;
      vs[i * ld + d] = t < T ? v[g] : 0.f;
    }
    __syncthreads();

    // Scores of this thread's keys, key c + kLanes * i of the tile.
    float s[kKeys];
#pragma unroll
    for (int i = 0; i < kKeys; ++i) s[i] = 0.f;
    for (int d = 0; d < dh; ++d) {
      const float qd = qs[r * ld + d];
#pragma unroll
      for (int i = 0; i < kKeys; ++i)
        s[i] = __fmaf_rn(qd, ks[(c + kLanes * i) * ld + d], s[i]);
    }
    float tile_max = -INFINITY;
#pragma unroll
    for (int i = 0; i < kKeys; ++i) {
      const int kpos = k0 + c + kLanes * i;
      const bool visible = kpos < T && (!causal || kpos <= qpos);
      s[i] = visible ? __fmul_rn(s[i], scale) : -INFINITY;
      tile_max = fmaxf(tile_max, s[i]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(kFull, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(kFull, tile_max, 2));
    const float m_new = fmaxf(m, tile_max);
    // A row that has seen no visible key yet adds nothing.
    const float corr = m_new == -INFINITY ? 1.f : expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < kKeys; ++i) {
      s[i] = s[i] == -INFINITY ? 0.f : expf(s[i] - m_new);
      psum += s[i];
    }
    psum += __shfl_xor_sync(kFull, psum, 1);
    psum += __shfl_xor_sync(kFull, psum, 2);
    l = l * corr + psum;
    m = m_new;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[j] *= corr;

    // acc += p @ V; key src + kLanes * i's p lives in s[i] of thread src of
    // this row.
#pragma unroll
    for (int i = 0; i < kKeys; ++i) {
#pragma unroll
      for (int src = 0; src < kLanes; ++src) {
        const float p = __shfl_sync(kFull, s[i], row_lane0 + src);
        const float* vrow = vs + (src + kLanes * i) * ld;
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int d = c + kLanes * j;
          if (d < dh) acc[j] = __fmaf_rn(p, vrow[d], acc[j]);
        }
      }
    }
  }

  if (qpos < T) {
    float* orow = o + base + static_cast<int64_t>(qpos) * dh;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int d = c + kLanes * j;
      if (d < dh) orow[d] = l == 0.f ? 0.f : acc[j] / l;
    }
  }
}

template <int NC>
int launch(const float* q, const float* k, const float* v, float* o,
           int64_t BH, int64_t T, int64_t dh, int64_t causal, float scale,
           cudaStream_t stream) {
  const int smem = static_cast<int>(3 * kRows * (dh + 1) * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((T + kRows - 1) / kRows),
                  static_cast<unsigned>(BH));
  flash_attention_kernel<NC><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, static_cast<int>(T), static_cast<int>(dh),
      static_cast<int>(causal), scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: float32 [BH, T, dh], contiguous; 0 < dh <= 128,
// BH <= 65535.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int64_t BH,
                                      int64_t T, int64_t dh, int64_t causal,
                                      float scale, void* stream) {
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(o);
  const auto st = static_cast<cudaStream_t>(stream);
  if (dh <= 0 || dh > 128 || BH <= 0 || BH > 65535 || T <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dh <= 16) return launch<4>(qf, kf, vf, of, BH, T, dh, causal, scale, st);
  if (dh <= 32) return launch<8>(qf, kf, vf, of, BH, T, dh, causal, scale, st);
  if (dh <= 64)
    return launch<16>(qf, kf, vf, of, BH, T, dh, causal, scale, st);
  return launch<32>(qf, kf, vf, of, BH, T, dh, causal, scale, st);
}
