// The ImageNet stem's tensor-core tile, run by K1 (stem_fused.cu: fp32
// input, quantized as it is staged), K10 (stem_int8.cu: int8 input,
// pooled or not) and the stage probes of probes.cu: 7x7/s2/p3 conv on 3
// channels, bias, ReLU, then either the 3x3/s2/p1 max pool on the int32
// accumulators and one requant of the pooled value (pooled), or a requant
// of every conv output (unpooled).
//
// Per output (image n, row, col, channel o):
//   xq   = the input value (fp32: clip(rint(x / scale), -128, 127), IEEE
//          divide)
//   conv = relu(sum xq * w[o] + bias[o])                      (int32)
//   out  = requant(max over the 3x3/s2/p1 window of conv)      (pooled)
//          requant(conv)                                       (unpooled)
// The max is taken on the int32 accumulators and only the pooled value is
// requantized: requant is monotone (positive factor, rint, clip), so it
// commutes with the max, and the padding (-1) never wins because every
// window holds its valid centre and a relu value is >= 0.
//
// The conv is regrouped by space-to-depth, as the TPU kernels run it: the
// 7x7/s2 taps, zero-padded at the front to 8x8, become a 4x4/s1 conv over
// 12 s2d channels (c, row parity, column parity), so a conv output is one
// row of a GEMM with K = 16 taps x 12 bytes = 192 and N = 64 output
// channels, exact in int8 (the added taps meet zero weights).
//
// Layout: x is [N, 3, H, W] (contiguous NCHW, fp32 or int8); wp is the
// packed weight [64, 192] int8, each channel's 192 bytes in the kernel's K
// order k = tap * 12 + c * 4 + rp * 2 + cp (tap = kh2 * 4 + kw2 over the
// 4x4 s2d taps; ops/stem_fused.py::pack_stem_weight); out is [N, 64, Ho,
// Wo] int8 in channels-last memory order ([N, Ho, Wo, 64] physically).
//
// A tile is one image's kTH x kTW outputs over the kCH x kCW conv outputs
// under them (kM conv positions, the GEMM's M, in m16 tiles):
//   pooled:   7 x 8 pooled outputs over 15 x 17 conv outputs (kM = 255, the
//             16th m16 tile pads one row); it tiles a 56 x 56 output (224 x
//             224 input) exactly, against the 1.2x edge recompute of 4 x 8.
//   unpooled: 16 x 16 conv outputs, disjoint (kM = 256, no pad row, no
//             recompute); an m16 tile is one conv row.
// Each tile:
//   1. staging: the input window under the tile is stored as int8 in
//      shared memory in s2d, channels-last order, [row pair][column
//      pair][12 bytes], the pairs counted from the window's own origin (so
//      any H and W), 0 outside the image.  Word c of a pair holds channel
//      c's bytes (rp, cp) = (0,0), (0,1), (1,0), (1,1) from the lowest
//      byte.  fp32 input is quantized here; int8 input is two 16-bit row
//      loads a word and one __byte_perm where W is even (a pair starts on
//      an even column, iw0 = 2 cw0 - 4, so it lies wholly inside or
//      outside the image), else byte loads.
//   2. the GEMM: mma.sync m16n8k32 (mma_s8.cuh), 6 K steps.  Word w of A
//      row m lies at base(m) + off(w) words, base(m) = r * kPitch + 3 q for
//      conv position (r, q) and off(w) = (w / 12) * kPitch + w % 12 (tap w
//      / 3, byte quad w % 3): one 32-bit shared load a fragment word.  A
//      warp holds the B fragments of its 32 channels in 48 registers for
//      the CTA's whole life; warp pairs split N, the four pairs split M.
//   3. pooled: acc + bias, ReLU into an int32 conv tile in shared memory,
//      -1 outside the conv output; the 3x3/s2 max (a thread walks two
//      pooled rows down one column, each conv row's 3-max read once), one
//      golden requant, and 64 contiguous bytes an output pixel.
//      unpooled: acc + bias, ReLU and the golden requant of every output
//      into an int8 tile in shared memory (2-byte stores, conflict-free at
//      an 80-byte row), then each pixel's 64 bytes as four 16-byte stores,
//      a warp covering 8 neighbouring pixels (512 contiguous bytes).
// CTAs are persistent (kCtasPerSm an SM, stem_plan in ops/stem_fused.py)
// and walk the (image, tile) list, so the weights are read once a CTA.
//
// kMode knocks stages out of the pooled tile for the probes of probes.cu
// (their outputs are not the stem's): K1 and K10 instantiate kFull, for
// which every ``if constexpr`` below keeps the code as it is.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "epilogue.cuh"
#include "mma_s8.cuh"

namespace stem_mma {

constexpr int kO = 64;                       // output channels
constexpr int kKWords = 48;                  // 192 K bytes a row
constexpr int kKSteps = 6;                   // k32 steps
constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kCtasPerSm = 2;

// Stages of the pooled tile a probe keeps: everything; the staging only
// (no GEMM, no pool: each output takes staged words); the GEMM, pool and
// stores without the input's loads (a pattern is quantized in their
// place); the GEMM with the unpooled epilogue in place of the conv tile
// and the pool (each output takes the requantized conv value at its
// window's centre).
enum Mode { kFull = 0, kStageOnly = 1, kNoLoads = 2, kNoPool = 3 };

// A row pair's pitch in words for kPC column pairs and kCW conv columns:
// room for kPC pairs of 3 words, and where an m16 tile's 8 rows of a
// fragment load may cross a conv row's end (kCW not a multiple of 16),
// base(m) = 3m + (conv row of m) mod 32, so they hit distinct banks or the
// same word.  Where they cannot, 8 rows of one conv row span 3 x 7 + 4 =
// 25 words and the least pitch does.
constexpr int row_pitch(int pc, int cw) {
  int p = 3 * pc;
  if (cw % 16 == 0) return p;
  while (p % 32 != (3 * cw + 1) % 32) ++p;
  return p;
}

template <bool kPool>
struct Tile {
  static constexpr int kTH = kPool ? 7 : 16;   // outputs a tile
  static constexpr int kTW = kPool ? 8 : 16;
  static constexpr int kCH = kPool ? 2 * kTH + 1 : kTH;  // conv rows: 15
  static constexpr int kCW = kPool ? 2 * kTW + 1 : kTW;  // conv cols: 17
  static constexpr int kM = kCH * kCW;                   // conv positions
  static constexpr int kMTiles = (kM + 15) / 16;         // m16 tiles: 16
  static constexpr int kPR = kCH + 3, kPC = kCW + 3;     // s2d pairs
  static constexpr int kStageItems = 3 * kPR * kPC;      // one word each
  static constexpr int kStageIters =
      (kStageItems + kThreads - 1) / kThreads;
  static constexpr int kPitch = row_pitch(kPC, kCW);
  // Conv tile row: 64 channels + 8 words, so the 64-bit fragment stores
  // of a half warp (4 rows x 4 column pairs) cover 32 banks.
  static constexpr int kRow = kO + 8;
  // Output tile row in bytes: 64 + 16, so a fragment's 2-byte stores (8
  // rows x 4 lanes) and 8 lanes' 16-byte reads of one part of 8
  // neighbouring rows hit distinct banks.
  static constexpr int kOutRow = kO + 16;
  // the int32 conv tile (pooled), or the int8 output tile
  static constexpr int kTileWords = kPool ? kM * kRow : kM * kOutRow / 4;
  static constexpr size_t kSmemBytes =
      sizeof(int) * (kTileWords + kPR * kPitch + 2 * kO);
};

// off(w) of the A word w, as above.
template <typename G>
__host__ __device__ constexpr int off(int w) {
  return (w / 12) * G::kPitch + w % 12;
}
template <typename G>
__device__ __forceinline__ int base(int m) {
  return (m / G::kCW) * G::kPitch + (m % G::kCW) * 3;
}
__device__ __forceinline__ int4 max4(int4 a, int4 b) {
  return make_int4(max(a.x, b.x), max(a.y, b.y), max(a.z, b.z),
                   max(a.w, b.w));
}

// 1. staging, fp32 input: item e is channel c's 2 x 2 values of one pair,
// quantized and packed as word c of the pair's 12 bytes.  All of a
// thread's loads are issued first (on the H100 that beats batches of 1-3
// items by 2-7 %).
template <typename G, int kMode>
__device__ __forceinline__ void stage(const float* __restrict__ xn,
                                      int* __restrict__ xs, int tid, int H,
                                      int W, int ih0, int iw0, float scale,
                                      bool) {
  float v[G::kStageIters][4];
#pragma unroll
  for (int k = 0; k < G::kStageIters; ++k) {
    const int e = tid + k * kThreads;
    const int c = e / (G::kPR * G::kPC), p = e - c * (G::kPR * G::kPC);
    const int ih = ih0 + 2 * (p / G::kPC), iw = iw0 + 2 * (p % G::kPC);
    const float* xp = xn + (static_cast<int64_t>(c) * H + ih) * W + iw;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const int h = ih + d / 2, w = iw + d % 2;
      if constexpr (kMode == kNoLoads) {
        v[k][d] = static_cast<float>(((e + d) & 15) - 8) * scale;
      } else {
        v[k][d] = (e < G::kStageItems && h >= 0 && h < H && w >= 0 && w < W)
                      ? __ldg(xp + (d / 2) * W + d % 2)
                      : 0.f;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < G::kStageIters; ++k) {
    const int e = tid + k * kThreads;
    if (e < G::kStageItems) {
      const int c = e / (G::kPR * G::kPC), p = e - c * (G::kPR * G::kPC);
      xs[(p / G::kPC) * G::kPitch + (p % G::kPC) * 3 + c] = pack4(
          quantize_i8(v[k][0], scale), quantize_i8(v[k][1], scale),
          quantize_i8(v[k][2], scale), quantize_i8(v[k][3], scale));
    }
  }
}

// 1. staging, int8 input: the pair's two rows as two 16-bit loads and one
// __byte_perm where ``pairs`` (W even and x 2-byte aligned), else four
// byte loads; 0 outside the image either way.  Loads first, as above.
template <typename G, int kMode>
__device__ __forceinline__ void stage(const int8_t* __restrict__ xn,
                                      int* __restrict__ xs, int tid, int H,
                                      int W, int ih0, int iw0, float,
                                      bool pairs) {
  uint32_t v[G::kStageIters];
  if (pairs) {
    uint32_t r[G::kStageIters][2];
#pragma unroll
    for (int k = 0; k < G::kStageIters; ++k) {
      const int e = tid + k * kThreads;
      const int c = e / (G::kPR * G::kPC), p = e - c * (G::kPR * G::kPC);
      const int ih = ih0 + 2 * (p / G::kPC), iw = iw0 + 2 * (p % G::kPC);
      const int8_t* xp = xn + (static_cast<int64_t>(c) * H + ih) * W + iw;
      const bool in_w = e < G::kStageItems && iw >= 0 && iw < W;
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        const int h = ih + d;
        r[k][d] = (in_w && h >= 0 && h < H)
                      ? __ldg(reinterpret_cast<const uint16_t*>(xp + d * W))
                      : 0u;
      }
    }
#pragma unroll
    for (int k = 0; k < G::kStageIters; ++k)
      v[k] = __byte_perm(r[k][0], r[k][1], 0x5410);
  } else {
    int b[G::kStageIters][4];
#pragma unroll
    for (int k = 0; k < G::kStageIters; ++k) {
      const int e = tid + k * kThreads;
      const int c = e / (G::kPR * G::kPC), p = e - c * (G::kPR * G::kPC);
      const int ih = ih0 + 2 * (p / G::kPC), iw = iw0 + 2 * (p % G::kPC);
      const int8_t* xp = xn + (static_cast<int64_t>(c) * H + ih) * W + iw;
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const int h = ih + d / 2, w = iw + d % 2;
        b[k][d] = (e < G::kStageItems && h >= 0 && h < H && w >= 0 && w < W)
                      ? __ldg(xp + (d / 2) * W + d % 2)
                      : 0;
      }
    }
#pragma unroll
    for (int k = 0; k < G::kStageIters; ++k)
      v[k] = pack4(b[k][0], b[k][1], b[k][2], b[k][3]);
  }
#pragma unroll
  for (int k = 0; k < G::kStageIters; ++k) {
    const int e = tid + k * kThreads;
    if (e < G::kStageItems) {
      const int c = e / (G::kPR * G::kPC), p = e - c * (G::kPR * G::kPC);
      xs[(p / G::kPC) * G::kPitch + (p % G::kPC) * 3 + c] =
          static_cast<int>(v[k]);
    }
  }
}

// The int8 output tile to the output: each of the tile's kTH x kTW pixels
// as four 16-byte parts, lane l of a warp on pixel 8 (warp's step) + l % 8,
// part l / 8; pixel i reads tile row i, or (kCentre) the conv row at its
// pooling window's centre.
template <typename G, bool kCentre>
__device__ __forceinline__ void store_tile(const int8_t* __restrict__ os,
                                           int8_t* __restrict__ out,
                                           int tid, int n, int oh0, int ow0,
                                           int Ho, int Wo) {
  constexpr int kPixels = G::kTH * G::kTW;
  static_assert(G::kTW % 8 == 0, "8 pixels of one row a quarter warp");
  for (int v = tid; v < ((kPixels * 4 + kThreads - 1) / kThreads) * kThreads;
       v += kThreads) {
    const int pix = (v / 32) * 8 + v % 8, part = v / 8 % 4;
    const int r = pix / G::kTW, q = pix % G::kTW;
    const int oh = oh0 + r, ow = ow0 + q;
    if (pix >= kPixels || oh >= Ho || ow >= Wo) continue;
    const int m = kCentre ? (2 * r + 1) * G::kCW + 2 * q + 1 : pix;
    *reinterpret_cast<int4*>(
        out + ((static_cast<int64_t>(n) * Ho + oh) * Wo + ow) * kO +
        16 * part) =
        *reinterpret_cast<const int4*>(os + m * G::kOutRow + 16 * part);
  }
}

// One CTA's walk over the (image, tile) list: tiles_w tiles an output row,
// tiles_img an image, tiles in all; kThreads threads, Tile<kPool>::
// kSmemBytes of dynamic shared memory.  Hc, Wc are the conv's output size,
// Ho, Wo the output's (pooled or not).  ``pairs`` as stage() takes it.
template <typename T, bool kPool, int kMode = kFull>
__device__ __forceinline__ void stem_tile(
    const T* __restrict__ x, const int* __restrict__ wp,
    const int32_t* __restrict__ bias, const float* __restrict__ factors,
    int8_t* __restrict__ out, int H, int W, int Hc, int Wc, int Ho, int Wo,
    int tiles_w, int tiles_img, int tiles, float scale, bool pairs) {
  using G = Tile<kPool>;
  // the conv tile's epilogue and the pool (K1's), or the int8 output tile
  constexpr bool kConvTile = kPool && kMode != kNoPool;
  extern __shared__ __align__(16) int smem[];
  int* cs = smem;                            // [kM][kRow] relu(conv)
  int8_t* os = reinterpret_cast<int8_t*>(smem);  // or [kM][kOutRow] int8
  int* xs = cs + G::kTileWords;              // [kPR][kPitch] s2d window
  int* bs = xs + G::kPR * G::kPitch;         // [kO] bias
  float* fs = reinterpret_cast<float*>(bs + kO);  // [kO] factors

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int nh = warp % 2, mw = warp / 2;    // N half, M quarter

  if (tid < kO) {
    bs[tid] = bias[tid];
    fs[tid] = factors[tid];
  }
  // B fragments of this warp's 32 channels: channel 32 nh + 8 j + g, K
  // words 8 s + t and 8 s + t + 4.
  int b[4][kKSteps][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int* wn = wp + (32 * nh + 8 * j + g) * kKWords + t;
#pragma unroll
    for (int s = 0; s < kKSteps; ++s) {
      b[j][s][0] = __ldg(wn + 8 * s);
      b[j][s][1] = __ldg(wn + 8 * s + 4);
    }
  }

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n = tile / tiles_img, rem = tile - n * tiles_img;
    const int oh0 = rem / tiles_w * G::kTH, ow0 = rem % tiles_w * G::kTW;
    // first conv row/col under the tile; the s2d window's first input
    // row/col: conv row ch0 + r reads rows 2 (ch0 + r) - 4 + kh8 for the
    // 8x8 taps kh8 = 2 kh2 + rp, i.e. row pair r + kh2 of the window
    const int ch0 = kPool ? 2 * oh0 - 1 : oh0;
    const int cw0 = kPool ? 2 * ow0 - 1 : ow0;
    const int ih0 = 2 * ch0 - 4, iw0 = 2 * cw0 - 4;

    stage<G, kMode>(x + static_cast<int64_t>(n) * 3 * H * W, xs, tid, H, W,
                    ih0, iw0, scale, pairs);
    __syncthreads();

    if constexpr (kMode == kStageOnly) {
      // each output's 64 bytes from staged words (and one B word)
      for (int it = tid; it < G::kTH * G::kTW * 8; it += kThreads) {
        const int pp = it / 8, og = it % 8;
        const int oh = oh0 + pp / G::kTW, ow = ow0 + pp % G::kTW;
        if (oh >= Ho || ow >= Wo) continue;
        const int* v = xs + (2 * it) % (G::kPR * G::kPitch - 2);
        *reinterpret_cast<int2*>(
            out + ((static_cast<int64_t>(n) * Ho + oh) * Wo + ow) * kO +
            og * 8) = make_int2(v[0] ^ b[0][0][0], v[1]);
      }
      __syncthreads();
      continue;
    }

    // 2-3. the GEMM and its epilogue into the conv or output tile
    for (int mt = mw; mt < G::kMTiles; mt += kWarps / 2) {
      const int m0 = 16 * mt;
      const int* a0 = xs + base<G>(min(m0 + g, G::kM - 1)) + t;
      const int* a1 = xs + base<G>(min(m0 + g + 8, G::kM - 1)) + t;
      int acc[4][4] = {};
#pragma unroll
      for (int s = 0; s < kKSteps; ++s) {
        const int a[4] = {a0[off<G>(8 * s)], a1[off<G>(8 * s)],
                          a0[off<G>(8 * s + 4)], a1[off<G>(8 * s + 4)]};
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[j], a, b[j][s][0], b[j][s][1]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + g + 8 * h;
        if (m >= G::kM) continue;           // the pad row: never pooled
        if constexpr (kConvTile) {
          const int r = m / G::kCW, q = m - r * G::kCW;
          const int ch = ch0 + r, cw = cw0 + q;
          const bool valid = ch >= 0 && ch < Hc && cw >= 0 && cw < Wc;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int o = 32 * nh + 8 * j + 2 * t;
            int2 c2;
            c2.x = valid ? max(acc[j][2 * h] + bs[o], 0) : -1;
            c2.y = valid ? max(acc[j][2 * h + 1] + bs[o + 1], 0) : -1;
            *reinterpret_cast<int2*>(cs + m * G::kRow + o) = c2;
          }
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int o = 32 * nh + 8 * j + 2 * t;
            const int q0 = requant_i8(max(acc[j][2 * h] + bs[o], 0), fs[o]);
            const int q1 =
                requant_i8(max(acc[j][2 * h + 1] + bs[o + 1], 0), fs[o + 1]);
            *reinterpret_cast<uint16_t*>(os + m * G::kOutRow + o) =
                static_cast<uint16_t>((q0 & 0xff) | ((q1 & 0xff) << 8));
          }
        }
      }
    }
    __syncthreads();

    if constexpr (!kConvTile) {
      store_tile<G, kPool>(os, out, tid, n, oh0, ow0, Ho, Wo);
    } else {
      // 3. pool + requant: thread (row group rg, column pc, channels 8 og
      // .. 8 og + 7) takes pooled rows 2 rg and 2 rg + 1 (rg 3: row 6
      // alone) at column pc, reading each of conv rows 4 rg .. 4 rg + 4
      // once: their horizontal 3-max, then the vertical 3-max of rows 0-2
      // and 2-4.  Eight neighbouring threads write one pixel's 64
      // contiguous bytes.
      static_assert(8 * G::kTW * (G::kTH + 1) / 2 == kThreads,
                    "pool threads");
      const int og = tid % 8, pc = tid / 8 % G::kTW, rg = tid / (8 * G::kTW);
      const int ow = ow0 + pc;
      const int nrows = 2 * rg + 1 < G::kTH ? 5 : 3;
      const float* f = fs + og * 8;
      int4 plo = make_int4(-1, -1, -1, -1), phi = plo, qlo = plo, qhi = plo;
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        if (i >= nrows) break;
        int4 lo = make_int4(-1, -1, -1, -1), hi = lo;
#pragma unroll
        for (int dc = 0; dc < 3; ++dc) {
          const int* cv =
              cs + ((4 * rg + i) * G::kCW + 2 * pc + dc) * G::kRow + og * 8;
          lo = max4(lo, *reinterpret_cast<const int4*>(cv));
          hi = max4(hi, *reinterpret_cast<const int4*>(cv + 4));
        }
        if (i <= 2) {
          plo = max4(plo, lo);
          phi = max4(phi, hi);
        }
        if (i >= 2) {
          qlo = max4(qlo, lo);
          qhi = max4(qhi, hi);
        }
        if (i == 2 || i == 4) {
          const int oh = oh0 + 2 * rg + (i == 4);
          if (oh < Ho && ow < Wo) {
            const int4 vl = i == 2 ? plo : qlo, vh = i == 2 ? phi : qhi;
            int2 packed;
            packed.x = pack4(requant_i8(vl.x, f[0]), requant_i8(vl.y, f[1]),
                             requant_i8(vl.z, f[2]), requant_i8(vl.w, f[3]));
            packed.y = pack4(requant_i8(vh.x, f[4]), requant_i8(vh.y, f[5]),
                             requant_i8(vh.z, f[6]), requant_i8(vh.w, f[7]));
            *reinterpret_cast<int2*>(
                out + ((static_cast<int64_t>(n) * Ho + oh) * Wo + ow) * kO +
                og * 8) = packed;
          }
        }
      }
    }
  }
}

// The signature of every __global__ wrapper of stem_tile.
template <typename T>
using Kernel = void (*)(const T*, const int*, const int32_t*, const float*,
                        int8_t*, int, int, int, int, int, int, int, int, int,
                        float, bool);

// Launches ``kernel`` (a wrapper of stem_tile<T, kPool, ...>) on ``ctas``
// persistent CTAs (ops/stem_fused.py::stem_plan, at most the tile count)
// over N images of H x W input and Ho x Wo output.
template <bool kPool, typename T>
int launch(Kernel<T> kernel, const void* x, const void* wp, const void* bias,
           const void* factors, void* out, int64_t N, int64_t H, int64_t W,
           int64_t Ho, int64_t Wo, int64_t ctas, float scale, bool pairs,
           cudaStream_t stream) {
  using G = Tile<kPool>;
  const int tiles_w = static_cast<int>((Wo + G::kTW - 1) / G::kTW);
  const int tiles_img = static_cast<int>((Ho + G::kTH - 1) / G::kTH) * tiles_w;
  const int64_t tiles = N * tiles_img;
  if (tiles == 0) return static_cast<int>(cudaSuccess);
  if (ctas < 1 || ctas > tiles || tiles > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(G::kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(ctas), kThreads, G::kSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const int*>(wp),
      static_cast<const int32_t*>(bias), static_cast<const float*>(factors),
      static_cast<int8_t*>(out), static_cast<int>(H), static_cast<int>(W),
      static_cast<int>((H - 1) / 2 + 1), static_cast<int>((W - 1) / 2 + 1),
      static_cast<int>(Ho), static_cast<int>(Wo), tiles_w, tiles_img,
      static_cast<int>(tiles), scale, pairs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace stem_mma
