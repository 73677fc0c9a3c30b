// K1: the whole ImageNet stem in one pass -- quantize, 7x7/s2/p3 conv,
// bias, ReLU, 3x3/s2/p1 max pool and requant -- with the conv on the int8
// tensor cores.
//
// Replaces resnet_accel_tpu/ops/stem_fused.py::_kernel (reached through
// stem_conv_pool_nm).  Like the TPU kernel it regroups the conv by
// space-to-depth: the 7x7/s2 taps, zero-padded at the front to 8x8, become
// a 4x4/s1 conv over 12 s2d channels (c, row parity, column parity), so a
// conv output is one row of a GEMM with K = 16 taps x 12 bytes = 192 and N
// = 64 output channels, exact in int8 (the added taps meet zero weights).
//
// Per output (image n, pooled row, col, channel o):
//   xq   = clip(rint(x / scale), -128, 127)        (IEEE divide)
//   conv = relu(sum xq * w[o] + bias[o])            (int32)
//   out  = requant(max over the 3x3/s2/p1 window of conv)
// The max is taken on the int32 accumulators and only the pooled value is
// requantized: requant is monotone (positive factor, rint, clip), so it
// commutes with the max, and the padding (-1) never wins because every
// window holds its valid centre and a relu value is >= 0.
//
// Layout: x is [N, 3, H, W] fp32 (contiguous NCHW); wp is the packed
// weight [64, 192] int8, each channel's 192 bytes in the kernel's K order
// k = tap * 12 + c * 4 + rp * 2 + cp (tap = kh2 * 4 + kw2 over the 4x4
// s2d taps; ops/stem_fused.py::pack_stem_weight); out is [N, 64, Hp, Wp]
// int8 in channels-last memory order ([N, Hp, Wp, 64] physically).
//
// A tile is one image's kTH x kTW pooled outputs, over the kCH x kCW conv
// outputs under them (kM = 255 conv positions, the GEMM's M, in 16 m16
// tiles: the last row pads).  7 x 8 pooled outputs give 255 = 16 x 16 - 1
// rows and tile a 56 x 56 output (224 x 224 input) exactly, against the
// 1.2x edge recompute of a 4 x 8 tile.  Each tile:
//   1. staging: the input window under the tile is quantized once and
//      stored as int8 in shared memory in s2d, channels-last order, [row
//      pair][column pair][12 bytes], the pairs counted from the window's
//      own origin (so any H and W), 0 outside the image; the row pair's
//      pitch (kPitch words) keeps every A load free of bank conflicts.
//   2. the GEMM: mma.sync m16n8k32 (mma_s8.cuh), 6 K steps.  Word w of A
//      row m lies at base(m) + off(w) words, base(m) = r * kPitch + 3 q for
//      conv position (r, q) and off(w) = (w / 12) * kPitch + w % 12 (tap w
//      / 3, byte quad w % 3): one 32-bit shared load a fragment word.  A
//      warp holds the B fragments of its 32 channels in 48 registers for
//      the CTA's whole life; warp pairs split N, the four pairs split M.
//   3. epilogue: acc + bias, ReLU into an int32 conv tile in shared memory,
//      -1 outside the conv output; the 3x3/s2 max (a thread walks two
//      pooled rows down one column, each conv row's 3-max read once), one
//      golden requant, and 64 contiguous bytes an output pixel.
// CTAs are persistent (kCtasPerSm an SM, stem_plan in ops/stem_fused.py)
// and walk the (image, tile) list, so the weights are read once a CTA.
//
// What bounds it: at batch 128 and 224 x 224 the 77 MB of fp32 input read
// once and the 26 MB output written once take 0.031 ms at 3.35 TB/s; the
// conv's 15.1 G multiply-adds take 0.015 ms at 1,979 TOP/s (the tiles'
// GEMMs do 22.5 G: the zero taps and the 1.14x edge recompute).  The
// staging (an IEEE divide a value, 1.5x over by the windows' overlap) and
// the pool are integer and FP32 issue.

#include <cuda_runtime.h>

#include <cstdint>

#include "epilogue.cuh"
#include "mma_s8.cuh"

namespace {

constexpr int kO = 64;                       // output channels
constexpr int kTH = 7, kTW = 8;              // pooled outputs a tile
constexpr int kCH = 2 * kTH + 1;             // conv rows under a tile: 15
constexpr int kCW = 2 * kTW + 1;             // conv cols: 17
constexpr int kM = kCH * kCW;                // conv positions: 255
constexpr int kMTiles = (kM + 15) / 16;      // m16 tiles: 16
constexpr int kPR = kCH + 3, kPC = kCW + 3;  // s2d row, column pairs
constexpr int kKWords = 48;                  // 192 K bytes a row
constexpr int kKSteps = 6;                   // k32 steps
constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kCtasPerSm = 2;
constexpr int kStageItems = 3 * kPR * kPC;   // one word each
constexpr int kStageIters = (kStageItems + kThreads - 1) / kThreads;
static_assert(8 * kTW * (kTH + 1) / 2 == kThreads, "pool threads");

// A row pair's pitch in words: room for kPC pairs of 3 words, and
// base(m) = 3m + (conv row of m) mod 32, so the 8 rows of a fragment load
// (within one conv row, or across one row end) hit distinct banks or the
// same word.
constexpr int row_pitch() {
  int p = 3 * kPC;
  while (p % 32 != (3 * kCW + 1) % 32) ++p;
  return p;
}
constexpr int kPitch = row_pitch();
// Conv tile row: 64 channels + 8 words, so the 64-bit fragment stores of
// a half warp (4 rows x 4 column pairs) cover 32 banks.
constexpr int kRow = kO + 8;

constexpr size_t kSmemBytes =
    sizeof(int) * (kM * kRow + kPR * kPitch + 2 * kO);

// off(w) of the A word w, as above.
__host__ __device__ constexpr int off(int w) {
  return (w / 12) * kPitch + w % 12;
}
__device__ __forceinline__ int4 max4(int4 a, int4 b) {
  return make_int4(max(a.x, b.x), max(a.y, b.y), max(a.z, b.z),
                   max(a.w, b.w));
}
__device__ __forceinline__ int base(int m) {
  return (m / kCW) * kPitch + (m % kCW) * 3;
}

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
stem_fused_kernel(const float* __restrict__ x, const int* __restrict__ wp,
                  const int32_t* __restrict__ bias,
                  const float* __restrict__ factors,
                  int8_t* __restrict__ out, int H, int W, int Hc, int Wc,
                  int Hp, int Wp, int tiles_w, int tiles_img, int tiles,
                  float scale) {
  extern __shared__ __align__(16) int smem[];
  int* cs = smem;                            // [kM][kRow] relu(conv)
  int* xs = cs + kM * kRow;                  // [kPR][kPitch] s2d window
  int* bs = xs + kPR * kPitch;               // [kO] bias
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
    const int oh0 = rem / tiles_w * kTH, ow0 = rem % tiles_w * kTW;
    // first conv row/col under the tile; the s2d window's first input
    // row/col: conv row ch0 + r reads rows 2 (ch0 + r) - 4 + kh8 for the
    // 8x8 taps kh8 = 2 kh2 + rp, i.e. row pair r + kh2 of the window
    const int ch0 = 2 * oh0 - 1, cw0 = 2 * ow0 - 1;
    const int ih0 = 2 * ch0 - 4, iw0 = 2 * cw0 - 4;

    // 1. staging: item e is channel c's 2 x 2 values of one pair, packed
    // as word c of the pair's 12 bytes (rp, cp) = (0,0), (0,1), (1,0),
    // (1,1) from the lowest byte.  All of a thread's loads are issued
    // first (on the H100 that beats batches of 1-3 items by 2-7 %).
    const float* xn = x + static_cast<int64_t>(n) * 3 * H * W;
    float v[kStageIters][4];
#pragma unroll
    for (int k = 0; k < kStageIters; ++k) {
      const int e = tid + k * kThreads;
      const int c = e / (kPR * kPC), p = e - c * (kPR * kPC);
      const int ih = ih0 + 2 * (p / kPC), iw = iw0 + 2 * (p % kPC);
      const float* xp = xn + (static_cast<int64_t>(c) * H + ih) * W + iw;
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const int h = ih + d / 2, w = iw + d % 2;
        v[k][d] = (e < kStageItems && h >= 0 && h < H && w >= 0 && w < W)
                      ? __ldg(xp + (d / 2) * W + d % 2)
                      : 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < kStageIters; ++k) {
      const int e = tid + k * kThreads;
      if (e < kStageItems) {
        const int c = e / (kPR * kPC), p = e - c * (kPR * kPC);
        xs[(p / kPC) * kPitch + (p % kPC) * 3 + c] = pack4(
            quantize_i8(v[k][0], scale), quantize_i8(v[k][1], scale),
            quantize_i8(v[k][2], scale), quantize_i8(v[k][3], scale));
      }
    }
    __syncthreads();

    // 2-3. the GEMM and its epilogue into the conv tile
    for (int mt = mw; mt < kMTiles; mt += kWarps / 2) {
      const int m0 = 16 * mt;
      const int* a0 = xs + base(min(m0 + g, kM - 1)) + t;
      const int* a1 = xs + base(min(m0 + g + 8, kM - 1)) + t;
      int acc[4][4] = {};
#pragma unroll
      for (int s = 0; s < kKSteps; ++s) {
        const int a[4] = {a0[off(8 * s)], a1[off(8 * s)],
                          a0[off(8 * s + 4)], a1[off(8 * s + 4)]};
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[j], a, b[j][s][0], b[j][s][1]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + g + 8 * h;
        if (m >= kM) continue;              // the pad row: never pooled
        const int r = m / kCW, q = m - r * kCW;
        const int ch = ch0 + r, cw = cw0 + q;
        const bool valid = ch >= 0 && ch < Hc && cw >= 0 && cw < Wc;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int o = 32 * nh + 8 * j + 2 * t;
          int2 c2;
          c2.x = valid ? max(acc[j][2 * h] + bs[o], 0) : -1;
          c2.y = valid ? max(acc[j][2 * h + 1] + bs[o + 1], 0) : -1;
          *reinterpret_cast<int2*>(cs + m * kRow + o) = c2;
        }
      }
    }
    __syncthreads();

    // 3. pool + requant: thread (row group rg, column pc, channels 8 og ..
    // 8 og + 7) takes pooled rows 2 rg and 2 rg + 1 (rg 3: row 6 alone) at
    // column pc, reading each of conv rows 4 rg .. 4 rg + 4 once: their
    // horizontal 3-max, then the vertical 3-max of rows 0-2 and 2-4.
    // Eight neighbouring threads write one pixel's 64 contiguous bytes.
    {
      const int og = tid % 8, pc = tid / 8 % kTW, rg = tid / (8 * kTW);
      const int ow = ow0 + pc;
      const int nrows = 2 * rg + 1 < kTH ? 5 : 3;
      const float* f = fs + og * 8;
      int4 plo = make_int4(-1, -1, -1, -1), phi = plo, qlo = plo, qhi = plo;
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        if (i >= nrows) break;
        int4 lo = make_int4(-1, -1, -1, -1), hi = lo;
#pragma unroll
        for (int dc = 0; dc < 3; ++dc) {
          const int* cv =
              cs + ((4 * rg + i) * kCW + 2 * pc + dc) * kRow + og * 8;
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
          if (oh < Hp && ow < Wp) {
            const int4 vl = i == 2 ? plo : qlo, vh = i == 2 ? phi : qhi;
            int2 packed;
            packed.x = pack4(requant_i8(vl.x, f[0]), requant_i8(vl.y, f[1]),
                             requant_i8(vl.z, f[2]), requant_i8(vl.w, f[3]));
            packed.y = pack4(requant_i8(vh.x, f[4]), requant_i8(vh.y, f[5]),
                             requant_i8(vh.z, f[6]), requant_i8(vh.w, f[7]));
            *reinterpret_cast<int2*>(
                out + ((static_cast<int64_t>(n) * Hp + oh) * Wp + ow) * kO +
                og * 8) = packed;
          }
        }
      }
    }
  }
}

}  // namespace

// ctas: the persistent grid (ops/stem_fused.py::stem_plan), at most the
// tile count.
extern "C" int stem_fused_launch(const void* x, const void* wp,
                                 const void* bias, const void* factors,
                                 void* out, int64_t N, int64_t H, int64_t W,
                                 int64_t Hp, int64_t Wp, int64_t ctas,
                                 float scale, void* stream) {
  const int tiles_w = static_cast<int>((Wp + kTW - 1) / kTW);
  const int tiles_img = static_cast<int>((Hp + kTH - 1) / kTH) * tiles_w;
  const int64_t tiles = N * tiles_img;
  if (tiles == 0) return static_cast<int>(cudaSuccess);
  if (ctas < 1 || ctas > tiles || tiles > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      stem_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  stem_fused_kernel<<<static_cast<unsigned>(ctas), kThreads, kSmemBytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(wp),
      static_cast<const int32_t*>(bias), static_cast<const float*>(factors),
      static_cast<int8_t*>(out), static_cast<int>(H), static_cast<int>(W),
      static_cast<int>((H - 1) / 2 + 1), static_cast<int>((W - 1) / 2 + 1),
      static_cast<int>(Hp), static_cast<int>(Wp), tiles_w, tiles_img,
      static_cast<int>(tiles), scale);
  return static_cast<int>(cudaGetLastError());
}
