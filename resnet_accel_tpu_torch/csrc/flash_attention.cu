// K5: attention with an online softmax, float32, on the tensor cores.
//
// Replaces resnet_accel_tpu/ops/flash_attention.py::_fa_kernel (:43),
// reached through flash_attention (:139) from the LM's prefill
// (TransformerBlockInt8._forward_kv with flash=True).
//
// Computes, for q, k, v float32 [BH, T, dh] and each row t of each head,
//   o[t] = softmax_j(q[t] . k[j] * scale) @ v
// over the visible keys j: j < T, and j <= t when causal.  A row with no
// visible key gives 0.  The [T, T] scores never reach device memory.
//
// What bounds it on the H100: at the LM's prefill (BH 8 heads, T 640, dh
// 64, causal) one launch needs 4 * BH * dh * T(T+1)/2 = 0.42 GFLOP (6.3 us
// at the 67 TFLOP/s FFMA peak, 0.9 us at the 495 TFLOP/s TF32 peak) and
// moves 5.2 MB (1.6 us at 3.35 TB/s).  So a launch this small is bound by
// how many SMs take part and how long each one's longest walk is, and the
// products by the rate of whatever unit runs them: an FFMA loop that reads
// one operand from shared memory for each multiply-add runs at the rate of
// shared memory, well below the FFMA peak.  The design:
//
// - Work items balanced and independent of BH.  Each 64-row q tile's
//   visible key tiles (64 keys each) are cut into chunks of ct tiles (the
//   wrapper's plan, ops/flash_attention.py::flash_plan: ct = max(2,
//   ceil(nq / 8)) for nq tiles of T, so a q tile has at most eight
//   chunks); one CTA of 4 warps computes one (head, q tile, chunk).  At T
//   640, causal: 30 items a head, 240 CTAs at BH 8 (not 80), none walking
//   more than 2 key tiles (not 10).  (On the H100, chunks of 2 tiles took
//   a batch-1 prefill launch from 0.067 to 0.056 ms against chunks of 4,
//   and left BH 64's at 0.21-0.22 ms: PERF.md §6.)  A q tile with one chunk writes its
//   rows; the others write their partial (m, l, acc) to a workspace, and a
//   second small kernel merges the partials in chunk order.  The chunks
//   and the merge order depend only on (T, dh, causal, the q tile), never
//   on BH or the card, so every head's rows are the same bits whatever BH
//   it runs in (a batched row of generate equals its single-prompt run).
// - Products on the tensor cores in split precision ("3xTF32"): each fp32
//   operand x is split into hi = tf32(x) (cvt.rna) and lo = tf32(x - hi),
//   and mma.sync.m16n8k8 (tf32 in, fp32 accumulate) sums lo*hi + hi*lo +
//   hi*hi, for S = Q K^T and for O += P V.  That keeps about fp32's
//   accuracy (the lo*lo term and the accumulator's rounding are what is
//   lost), as the TPU kernel's HIGHEST-precision dots keep it with bf16 in
//   six passes; three passes still run at 165 TFLOP/s of TF32 peak, 2.5x
//   the FFMA peak.  A warp owns 16 q rows: S's fragment stays in
//   registers, the softmax runs on it (row max and sum across the quad of
//   lanes that holds a row), and it becomes P's fragment for P V with no
//   trip through shared memory: the key order inside each k8 step is
//   permuted to match the accumulator's layout, and V's rows are read in
//   the same order.  Rows in shared memory are dh + 4 floats apart, so
//   every fragment read is free of bank conflicts.
// - K and V tiles double-buffered with cp.async (zero-filled past T and
//   past dh), so the next tile loads while the warps work on this one.
//
// exp is expf, and the build's -fmad=false keeps every multiply and add
// outside the tensor cores separately rounded.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kRows = 64;                 // q rows a CTA; keys a tile
constexpr int kWarps = 4;                 // 16 q rows a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kMergeThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// ---- the plan's items (ops/flash_attention.py::flash_plan) ----------------

__host__ __device__ __forceinline__ int chunks_of(int qt, int nq, int ct,
                                                  int causal) {
  const int vis = causal ? qt + 1 : nq;
  return (vis + ct - 1) / ct;
}

// Items of a head: q tile 0's chunks, then q tile 1's, ...
__host__ __device__ __forceinline__ int items_before(int qt, int nq, int ct,
                                                     int causal) {
  if (!causal) return qt * chunks_of(0, nq, ct, 0);
  int n = 0;
  for (int i = 0; i < qt; ++i) n += chunks_of(i, nq, ct, 1);
  return n;
}

// ---- PTX ------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes (or, with src_bytes 0, zeros) to shared memory, asynchronously.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// x = hi + lo, each a TF32 value (hi rounded to nearest, ties away).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  const float r = __fsub_rn(x, __uint_as_float(hi));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(r));
}

// d[16 x 8] += a[16 x 8] . b[8 x 8], tf32 in, fp32 accumulate.  With g =
// lane / 4 and t = lane % 4: a = (g, t), (g + 8, t), (g, t + 4), (g + 8,
// t + 4); b = (k t, n g), (k t + 4, n g); d = (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b in three passes: lo.hi, hi.lo, then hi.hi.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4],
                                           float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma_tf32(d, alo, bh0, bh1);
  mma_tf32(d, ahi, bl0, bl1);
  mma_tf32(d, ahi, bh0, bh1);
}

// ---- the kernels ----------------------------------------------------------

// Rows [row0, row0 + kRows) of one head's [T, dh] into dst [kRows][LD],
// zero past T and past dh (vec: dh % 4 == 0, 16-byte copies).
template <int DH>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int T, int dh, bool vec,
                                          int tid) {
  constexpr int LD = DH + 4;
  if (vec) {
    for (int e = tid; e < kRows * DH / 4; e += kThreads) {
      const int r = e / (DH / 4), c = 4 * (e % (DH / 4)), t = row0 + r;
      const bool in = t < T && c < dh;
      cp_async16(dst + r * LD + c,
                 in ? src + static_cast<int64_t>(t) * dh + c : src,
                 in ? 16 : 0);
    }
  } else {
    for (int e = tid; e < kRows * DH; e += kThreads) {
      const int r = e / DH, c = e % DH, t = row0 + r;
      const bool in = t < T && c < dh;
      cp_async4(dst + r * LD + c,
                in ? src + static_cast<int64_t>(t) * dh + c : src,
                in ? 4 : 0);
    }
  }
}

// One (head, q tile, chunk) a CTA; grid (items of a head, BH), the last
// q tiles' items first.  ws: the partials of q tiles with more than one
// chunk, [BH][items][kRows * DH + 2 * kRows] floats (acc, then m and l of
// each row).
template <int DH>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ ws, int T, int dh, int causal,
                           int ct, float scale, int vec) {
  constexpr int LD = DH + 4;
  constexpr int NT = DH / 8;  // 8-column tiles of dh
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                   // [kRows][LD]
  float* ks = qs + kRows * LD;        // [2][kRows][LD]
  float* vs = ks + 2 * kRows * LD;    // [2][kRows][LD]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int nq = (T + kRows - 1) / kRows;
  // this CTA's item: q tile qt, chunk ch
  const int item = gridDim.x - 1 - blockIdx.x;
  int qt = 0, ch = item;
  while (ch >= chunks_of(qt, nq, ct, causal)) {
    ch -= chunks_of(qt, nq, ct, causal);
    ++qt;
  }
  const int nchunks = chunks_of(qt, nq, ct, causal);
  const int vis = causal ? qt + 1 : nq;
  const int kt0 = ch * ct, kt1 = min(vis, kt0 + ct);
  const int q0 = qt * kRows;
  const int64_t head = static_cast<int64_t>(blockIdx.y) * T * dh;

  load_tile<DH>(qs, q + head, q0, T, dh, vec, tid);
  load_tile<DH>(ks, k + head, kt0 * kRows, T, dh, vec, tid);
  load_tile<DH>(vs, v + head, kt0 * kRows, T, dh, vec, tid);
  cp_async_commit();

  const int ra = warp * 16 + g;           // this lane's rows ra, ra + 8
  const int qa = q0 + ra, qb = qa + 8;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int c = 0; c < NT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int buf = (kt - kt0) & 1;
    if (kt + 1 < kt1) {
      load_tile<DH>(ks + (buf ^ 1) * kRows * LD, k + head, (kt + 1) * kRows,
                    T, dh, vec, tid);
      load_tile<DH>(vs + (buf ^ 1) * kRows * LD, v + head, (kt + 1) * kRows,
                    T, dh, vec, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* kb = ks + buf * kRows * LD;
    const float* vb = vs + buf * kRows * LD;

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      uint32_t ahi[4], alo[4];
      split(qs[ra * LD + 8 * kk + t4], ahi[0], alo[0]);
      split(qs[(ra + 8) * LD + 8 * kk + t4], ahi[1], alo[1]);
      split(qs[ra * LD + 8 * kk + t4 + 4], ahi[2], alo[2]);
      split(qs[(ra + 8) * LD + 8 * kk + t4 + 4], ahi[3], alo[3]);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float* kr = kb + (8 * n + g) * LD + 8 * kk + t4;
        mma_3xtf32(s[n], ahi, alo, kr[0], kr[4]);
      }
    }

    // scale, mask, and the online softmax of rows qa (e < 2) and qb
    const int k0 = kt * kRows;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * n + 2 * t4 + (e & 1);
        const int row = e < 2 ? qa : qb;
        const bool visible = key < T && (!causal || key <= row);
        s[n][e] = visible ? __fmul_rn(s[n][e], scale) : -INFINITY;
        mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      // a row that has seen no visible key yet adds nothing
      corr[h] = m_new == -INFINITY ? 1.f : expf(m[h] - m_new);
      m[h] = m_new;
      l[h] = __fmul_rn(l[h], corr[h]);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        s[n][e] = s[n][e] == -INFINITY ? 0.f : expf(s[n][e] - m[h]);
        l[h] = __fadd_rn(l[h], s[n][e]);
      }
#pragma unroll
    for (int c = 0; c < NT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] = __fmul_rn(acc[c][e], corr[e / 2]);

    // O += P V: k8 step j takes keys 8j + 2t (as column t) and 8j + 2t + 1
    // (as column t + 4), the columns S's fragment holds, and V's rows in
    // the same order
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t ahi[4], alo[4];
      split(s[j][0], ahi[0], alo[0]);
      split(s[j][2], ahi[1], alo[1]);
      split(s[j][1], ahi[2], alo[2]);
      split(s[j][3], ahi[3], alo[3]);
      const float* v0 = vb + (8 * j + 2 * t4) * LD + g;
#pragma unroll
      for (int c = 0; c < NT; ++c)
        mma_3xtf32(acc[c], ahi, alo, v0[8 * c], v0[LD + 8 * c]);
    }
    __syncthreads();  // this buffer is free for the tile after next
  }

  // the rows' sums across the quad
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = __fadd_rn(l[h], __shfl_xor_sync(kFull, l[h], 1));
    l[h] = __fadd_rn(l[h], __shfl_xor_sync(kFull, l[h], 2));
  }
  if (nchunks == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = h ? qb : qa;
      if (row >= T) continue;
      float* orow = o + head + static_cast<int64_t>(row) * dh;
#pragma unroll
      for (int c = 0; c < NT; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = 8 * c + 2 * t4 + e;
          if (d < dh)
            orow[d] = l[h] == 0.f ? 0.f : __fdiv_rn(acc[c][2 * h + e], l[h]);
        }
    }
    return;
  }
  const int items = items_before(nq, nq, ct, causal);
  float* part = ws + (static_cast<int64_t>(blockIdx.y) * items +
                      items_before(qt, nq, ct, causal) + ch) *
                         (kRows * DH + 2 * kRows);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = ra + 8 * h;
#pragma unroll
    for (int c = 0; c < NT; ++c)
      *reinterpret_cast<float2*>(part + r * DH + 8 * c + 2 * t4) =
          make_float2(acc[c][2 * h], acc[c][2 * h + 1]);
    if (t4 == 0) {
      part[kRows * DH + 2 * r] = m[h];
      part[kRows * DH + 2 * r + 1] = l[h];
    }
  }
}

// The rows of q tiles with more than one chunk, from their partials in
// chunk order: M = max m_c, l = sum l_c e^(m_c - M), o = sum acc_c
// e^(m_c - M) / l.  Grid (q tiles, BH).
template <int DH>
__global__ void __launch_bounds__(kMergeThreads)
    flash_merge_kernel(const float* __restrict__ ws, float* __restrict__ o,
                       int T, int dh, int causal, int ct) {
  const int nq = (T + kRows - 1) / kRows;
  const int qt = blockIdx.x, nchunks = chunks_of(qt, nq, ct, causal);
  if (nchunks == 1) return;
  const int items = items_before(nq, nq, ct, causal);
  const int64_t stride = kRows * DH + 2 * kRows;
  const float* part = ws + (static_cast<int64_t>(blockIdx.y) * items +
                            items_before(qt, nq, ct, causal)) * stride;
  float* out = o + static_cast<int64_t>(blockIdx.y) * T * dh;
  for (int e = threadIdx.x; e < kRows * dh; e += kMergeThreads) {
    const int r = e / dh, d = e % dh, row = qt * kRows + r;
    if (row >= T) continue;
    float mmax = -INFINITY;
    for (int c = 0; c < nchunks; ++c)
      mmax = fmaxf(mmax, part[c * stride + kRows * DH + 2 * r]);
    float lsum = 0.f, sum = 0.f;
    if (mmax != -INFINITY) {
      for (int c = 0; c < nchunks; ++c) {
        const float* pc = part + c * stride;
        const float mc = pc[kRows * DH + 2 * r];
        const float w = mc == -INFINITY ? 0.f : expf(mc - mmax);
        lsum = __fadd_rn(lsum, __fmul_rn(pc[kRows * DH + 2 * r + 1], w));
        sum = __fadd_rn(sum, __fmul_rn(pc[r * DH + d], w));
      }
    }
    out[static_cast<int64_t>(row) * dh + d] =
        lsum == 0.f ? 0.f : __fdiv_rn(sum, lsum);
  }
}

template <int DH>
int launch(const float* q, const float* k, const float* v, float* o,
           float* ws, int64_t BH, int64_t T, int64_t dh, int64_t causal,
           int ct, float scale, cudaStream_t stream) {
  const int smem = static_cast<int>(5 * kRows * (DH + 4) * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nq = static_cast<int>((T + kRows - 1) / kRows);
  const int items = items_before(nq, nq, ct, static_cast<int>(causal));
  const bool merge = chunks_of(nq - 1, nq, ct, static_cast<int>(causal)) > 1;
  if (merge && ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = dh % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v) % 16 == 0;
  flash_attention_kernel<DH>
      <<<dim3(static_cast<unsigned>(items), static_cast<unsigned>(BH)),
         kThreads, smem, stream>>>(q, k, v, o, ws, static_cast<int>(T),
                                   static_cast<int>(dh),
                                   static_cast<int>(causal), ct, scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || !merge) return static_cast<int>(err);
  flash_merge_kernel<DH>
      <<<dim3(static_cast<unsigned>(nq), static_cast<unsigned>(BH)),
         kMergeThreads, 0, stream>>>(ws, o, static_cast<int>(T),
                                     static_cast<int>(dh),
                                     static_cast<int>(causal), ct);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: float32 [BH, T, dh], contiguous; 0 < dh <= 128, BH <= 65535;
// ws: the partials' workspace, BH times flash_plan's ws_floats floats (null
// where no q tile has more than one chunk); ct: key tiles a chunk.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* ws,
                                      int64_t BH, int64_t T, int64_t dh,
                                      int64_t causal, int64_t ct, float scale,
                                      void* stream) {
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(o);
  auto* wf = static_cast<float*>(ws);
  const auto st = static_cast<cudaStream_t>(stream);
  if (dh <= 0 || dh > 128 || BH <= 0 || BH > 65535 || T <= 0 ||
      T > (int64_t{1} << 24) || ct < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int c = static_cast<int>(ct);
  if (dh <= 16)
    return launch<16>(qf, kf, vf, of, wf, BH, T, dh, causal, c, scale, st);
  if (dh <= 32)
    return launch<32>(qf, kf, vf, of, wf, BH, T, dh, causal, c, scale, st);
  if (dh <= 64)
    return launch<64>(qf, kf, vf, of, wf, BH, T, dh, causal, c, scale, st);
  return launch<128>(qf, kf, vf, of, wf, BH, T, dh, causal, c, scale, st);
}
