// The ImageNet stem's scalar tile, run by K10 (stem_int8.cu, int8 input)
// and by the timing probes of probes.cu (fp32 input quantized on load; K1,
// stem_fused.cu, has a tensor-core tile of its own): 7x7/s2/p3 conv on 3
// channels, bias, ReLU, then either the 3x3/s2/p1 max pool on the int32
// accumulators and one requant of the pooled value (kPool), or a requant
// of every conv output.
//
// Per output (image n, row, col, channel o):
//   xq   = the input value (fp32: clip(rint(x / scale), -128, 127))
//   conv = relu(sum_{c,kh,kw} xq * w[o,c,kh,kw] + bias[o])  (int32)
//   out  = requant(max over the 3x3/s2/p1 window of conv)  (kPool)
//          requant(conv)                                    (otherwise)
// The max is taken on the int32 accumulators and only the pooled value is
// requantized: requant is monotone (positive factor, rint, clip), so it
// commutes with the max, and the padding never wins because every window
// holds its valid centre.
//
// Layout: x is [N, 3, H, W] (contiguous NCHW), w is [64, 3, 7, 7] int8
// (OIHW), out is [N, 64, Ho, Wo] int8 in channels-last memory order
// ([N, Ho, Wo, 64] physically), the layout the conv kernel reads next.
//
// The work is 15.1 G multiply-adds at batch 128 and 224 x 224 on 3 input
// channels, a shape no int8 tensor-core path or __dp4a suits, so it runs
// as scalar int32 multiply-adds and is bound by integer issue.  A block
// takes one image and a tile of outputs (pooled: 4 x 8, over 9 x 17 conv
// outputs, 1.2x recompute at tile edges instead of a round trip through
// device memory; unpooled: 8 x 16 conv outputs), stages the input window
// it needs and the 147 x 64 weights as int32 in shared memory, and
// computes the conv outputs with one register multiply-add plus a shared
// load amortised over eight channels.  A warp shares one group of eight
// output channels, so weight reads are broadcasts.
//
// kAblate knocks stages out of the pooled tile for the timing probes of
// probes.cu (their outputs are not the stem's): K10 and the probes' full
// tile instantiate kFull, for which every ``if constexpr`` below keeps the
// code as it is.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "epilogue.cuh"

namespace stem {

constexpr int kC = 3, kK = 7, kO = 64;
constexpr int kTaps = kC * kK * kK;            // 147
constexpr int kRow = kO + 4;                   // padded row: no bank clash
constexpr int kThreads = 256;

// Stages of the tile a probe keeps: everything; the staging only (no dots,
// no pool: each output takes staged values); the dots, pool and stores
// without the input's loads and quantize (the window holds a pattern);
// the dots without the pool (each output requantizes one conv value).
enum Ablate { kFull = 0, kStageOnly = 1, kNoLoads = 2, kNoPool = 3 };

template <bool kPool>
struct Tile {
  static constexpr int kTH = kPool ? 4 : 8;    // outputs per block
  static constexpr int kTW = kPool ? 8 : 16;
  static constexpr int kCH = kPool ? 2 * kTH + 1 : kTH;  // conv rows
  static constexpr int kCW = kPool ? 2 * kTW + 1 : kTW;  // conv cols
  static constexpr int kIH = 2 * (kCH - 1) + kK;         // input rows
  static constexpr int kIW = 2 * (kCW - 1) + kK;         // input cols
  static constexpr int kXs = (kC * kIH * kIW + 3) / 4 * 4;  // cs 16B-aligned
  static constexpr size_t kSmemBytes =
      sizeof(int) * (kTaps * kRow + kXs + kCH * kCW * kRow);
};

// The staged input value: K1 quantizes fp32 (IEEE divide, rint, clip).
__device__ __forceinline__ int load_input(const float* p, float scale) {
  return quantize_i8(__ldg(p), scale);
}
__device__ __forceinline__ int load_input(const int8_t* p, float) {
  return __ldg(p);
}

// One block's tile; grid (ceil(Wo / kTW), ceil(Ho / kTH), N), kThreads
// threads, Tile<kPool>::kSmemBytes of dynamic shared memory.  Hc, Wc are
// the conv's output size, Ho, Wo the output's (pooled or not).
template <typename T, bool kPool, int kAblate = kFull>
__device__ __forceinline__ void stem_tile(
    const T* __restrict__ x, const int8_t* __restrict__ w,
    const int32_t* __restrict__ bias, const float* __restrict__ factors,
    int8_t* __restrict__ out, int H, int W, int Hc, int Wc, int Ho, int Wo,
    float scale) {
  using G = Tile<kPool>;
  extern __shared__ __align__(16) int smem[];
  int* ws = smem;                         // [kTaps][kRow] weights
  int* xs = ws + kTaps * kRow;            // [kC][kIH][kIW] input window
  int* cs = xs + G::kXs;                  // [kCH*kCW][kRow] relu(conv)

  const int tid = threadIdx.x;
  const int n = blockIdx.z;
  const int oh0 = blockIdx.y * G::kTH, ow0 = blockIdx.x * G::kTW;
  // first conv row/col under the tile, then the first input row/col
  const int ch0 = kPool ? 2 * oh0 - 1 : oh0, cw0 = kPool ? 2 * ow0 - 1 : ow0;
  const int ih0 = 2 * ch0 - 3, iw0 = 2 * cw0 - 3;

  for (int e = tid; e < kO * kTaps; e += kThreads) {
    const int o = e / kTaps, t = e - o * kTaps;
    ws[t * kRow + o] = w[e];
  }
  const T* xn = x + static_cast<int64_t>(n) * kC * H * W;
  for (int e = tid; e < kC * G::kIH * G::kIW; e += kThreads) {
    const int c = e / (G::kIH * G::kIW), rem = e - c * (G::kIH * G::kIW);
    const int ih = ih0 + rem / G::kIW, iw = iw0 + rem % G::kIW;
    if constexpr (kAblate == kNoLoads) {
      xs[e] = (e & 15) - 8;
      continue;
    }
    xs[e] = (ih >= 0 && ih < H && iw >= 0 && iw < W)
                ? load_input(xn + (static_cast<int64_t>(c) * H + ih) * W + iw,
                             scale)
                : 0;
  }
  __syncthreads();

  if constexpr (kAblate == kStageOnly) {
    for (int it = tid; it < G::kTH * G::kTW * 8; it += kThreads) {
      const int pp = it / 8, og = it % 8;
      const int oh = oh0 + pp / G::kTW, ow = ow0 + pp % G::kTW;
      if (oh >= Ho || ow >= Wo) continue;
      const int* v = xs + (8 * it) % (G::kXs - 8);
      int2 packed;
      packed.x = pack4(v[0], v[1], v[2], v[3] + ws[og]);
      packed.y = pack4(v[4], v[5], v[6], v[7]);
      *reinterpret_cast<int2*>(
          out + ((static_cast<int64_t>(n) * Ho + oh) * Wo + ow) * kO +
          og * 8) = packed;
    }
    return;
  }

  // Conv outputs under the tile: warp = one group of 8 channels, lanes
  // walk the kCH x kCW positions.
  const int cg = tid / 32, lane = tid % 32;
  int b[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) b[j] = bias[cg * 8 + j];
  for (int p = lane; p < G::kCH * G::kCW; p += 32) {
    const int r = p / G::kCW, q = p - r * G::kCW;
    const int ch = ch0 + r, cw = cw0 + q;
    int acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = b[j];
    const bool valid = ch >= 0 && ch < Hc && cw >= 0 && cw < Wc;
    if (valid) {
      for (int c = 0; c < kC; ++c) {
        for (int kh = 0; kh < kK; ++kh) {
          const int* xrow = xs + (c * G::kIH + 2 * r + kh) * G::kIW + 2 * q;
          const int* wrow = ws + ((c * kK + kh) * kK) * kRow + cg * 8;
#pragma unroll
          for (int kw = 0; kw < kK; ++kw) {
            const int xv = xrow[kw];
            const int4 w0 = *reinterpret_cast<const int4*>(wrow + kw * kRow);
            const int4 w1 =
                *reinterpret_cast<const int4*>(wrow + kw * kRow + 4);
            acc[0] += xv * w0.x; acc[1] += xv * w0.y;
            acc[2] += xv * w0.z; acc[3] += xv * w0.w;
            acc[4] += xv * w1.x; acc[5] += xv * w1.y;
            acc[6] += xv * w1.z; acc[7] += xv * w1.w;
          }
        }
      }
    }
    // Outside the conv output the pool pads; -1 loses to any relu value.
    int4 lo, hi;
    lo.x = valid ? max(acc[0], 0) : -1; lo.y = valid ? max(acc[1], 0) : -1;
    lo.z = valid ? max(acc[2], 0) : -1; lo.w = valid ? max(acc[3], 0) : -1;
    hi.x = valid ? max(acc[4], 0) : -1; hi.y = valid ? max(acc[5], 0) : -1;
    hi.z = valid ? max(acc[6], 0) : -1; hi.w = valid ? max(acc[7], 0) : -1;
    *reinterpret_cast<int4*>(cs + p * kRow + cg * 8) = lo;
    *reinterpret_cast<int4*>(cs + p * kRow + cg * 8 + 4) = hi;
  }
  __syncthreads();

  // Pool (kPool) + requant: an item is one output pixel x 8 channels;
  // eight neighbouring threads write one pixel's 64 contiguous bytes.
  for (int it = tid; it < G::kTH * G::kTW * 8; it += kThreads) {
    const int pp = it / 8, og = it % 8;
    const int pr = pp / G::kTW, pc = pp % G::kTW;
    const int oh = oh0 + pr, ow = ow0 + pc;
    if (oh >= Ho || ow >= Wo) continue;
    int m[8];
    if constexpr (kAblate == kNoPool) {
      const int* v = cs + ((2 * pr + 1) * G::kCW + 2 * pc + 1) * kRow + og * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) m[j] = v[j];
    } else if (kPool) {
#pragma unroll
      for (int j = 0; j < 8; ++j) m[j] = -1;
      for (int dr = 0; dr < 3; ++dr)
        for (int dc = 0; dc < 3; ++dc) {
          const int* v =
              cs + ((2 * pr + dr) * G::kCW + 2 * pc + dc) * kRow + og * 8;
#pragma unroll
          for (int j = 0; j < 8; ++j) m[j] = max(m[j], v[j]);
        }
    } else {
      const int* v = cs + pp * kRow + og * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) m[j] = v[j];
    }
    int q[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) q[j] = requant_i8(m[j], factors[og * 8 + j]);
    int2 packed;
    packed.x = pack4(q[0], q[1], q[2], q[3]);
    packed.y = pack4(q[4], q[5], q[6], q[7]);
    *reinterpret_cast<int2*>(
        out + ((static_cast<int64_t>(n) * Ho + oh) * Wo + ow) * kO + og * 8) =
        packed;
  }
}

// The stem conv's output size (7x7/s2/p3) and the pooled size (3x3/s2/p1).
inline int conv_out(int64_t v) { return static_cast<int>((v - 1) / 2 + 1); }

// Grid of a tile kernel over outputs of Ho x Wo for N images.
template <bool kPool>
inline dim3 grid(int64_t N, int64_t Ho, int64_t Wo) {
  using G = Tile<kPool>;
  return dim3(static_cast<unsigned>((Wo + G::kTW - 1) / G::kTW),
              static_cast<unsigned>((Ho + G::kTH - 1) / G::kTH),
              static_cast<unsigned>(N));
}

}  // namespace stem
