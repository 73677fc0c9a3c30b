// K1: the whole ImageNet stem in one pass -- quantize, 7x7/s2/p3 conv,
// bias, ReLU, 3x3/s2/p1 max pool and requant.
//
// Replaces resnet_accel_tpu/ops/stem_fused.py::_kernel (reached through
// stem_conv_pool_nm).  The TPU kernel regrouped the conv by space-to-depth
// into a 4x4 conv so the 128x128 MXU had work; that is bit-identical but
// buys nothing here, so this kernel computes the 7x7/s2 conv directly.
//
// Per output (image n, pooled row ph, pooled col pw, channel o):
//   xq   = clip(rint(x / scale), -128, 127)                (IEEE divide)
//   conv = relu(sum_{c,kh,kw} xq * w[o,c,kh,kw] + bias[o])  (int32)
//   out  = requant(max over the 3x3/s2/p1 window of conv)
// The max is taken on the int32 accumulators and only the pooled value is
// requantized: requant is monotone (positive factor, rint, clip), so it
// commutes with the max, and the padding never wins because every window
// holds its valid centre.
//
// Layout: x is [N, 3, H, W] fp32 (contiguous NCHW, the caller's images),
// w is [64, 3, 7, 7] int8 (OIHW), out is [N, 64, Hp, Wp] int8 in
// channels-last memory order ([N, Hp, Wp, 64] physically), the layout the
// conv kernel reads next.
//
// What bounds it on the H100: at batch 128 and 224x224 the conv is 15.1 G
// multiply-adds on 3 input channels, a shape no int8 tensor-core path or
// __dp4a suits, so it runs as scalar int32 multiply-adds and is bound by
// integer issue; the fp32 input (77 MB) is read about once and the pooled
// int8 output (26 MB) written once.  The design stages everything in
// shared memory so each multiply-add costs one register operation plus a
// shared load amortised over eight channels: a block takes one image and a
// 4 x 8 tile of pooled outputs, quantizes the 23 x 39 x 3 input window it
// needs, keeps the 147 x 64 weights as int32, computes the 9 x 17 conv
// outputs under the pool windows (1.2x recompute at tile edges instead of
// a round trip through device memory), then pools and requantizes.
// A warp shares one group of eight output channels, so weight reads are
// broadcasts.

#include <cuda_runtime.h>

#include <cstdint>

#include "epilogue.cuh"

namespace {

constexpr int kC = 3, kK = 7, kO = 64;
constexpr int kTaps = kC * kK * kK;            // 147
constexpr int kTPH = 4, kTPW = 8;              // pooled outputs per block
constexpr int kCH = 2 * kTPH + 1;              // conv rows under the tile
constexpr int kCW = 2 * kTPW + 1;              // conv cols under the tile
constexpr int kIH = 2 * (kCH - 1) + kK;        // input rows needed
constexpr int kIW = 2 * (kCW - 1) + kK;        // input cols needed
constexpr int kRow = kO + 4;                   // padded row: no bank clash
constexpr int kXs = (kC * kIH * kIW + 3) / 4 * 4;  // keeps cs 16B-aligned
constexpr int kThreads = 256;

constexpr size_t kSmemBytes =
    sizeof(int) * (kTaps * kRow + kXs + kCH * kCW * kRow);

__global__ void __launch_bounds__(kThreads)
stem_fused_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                  const int32_t* __restrict__ bias,
                  const float* __restrict__ factors,
                  int8_t* __restrict__ out, int H, int W, int Hc, int Wc,
                  int Hp, int Wp, float scale) {
  extern __shared__ __align__(16) int smem[];
  int* ws = smem;                         // [kTaps][kRow] weights
  int* xs = ws + kTaps * kRow;            // [kC][kIH][kIW] quantized input
  int* cs = xs + kXs;                     // [kCH*kCW][kRow] relu(conv)

  const int tid = threadIdx.x;
  const int n = blockIdx.z;
  const int ph0 = blockIdx.y * kTPH, pw0 = blockIdx.x * kTPW;
  const int ch0 = 2 * ph0 - 1, cw0 = 2 * pw0 - 1;  // first conv row/col
  const int ih0 = 2 * ch0 - 3, iw0 = 2 * cw0 - 3;  // first input row/col

  for (int e = tid; e < kO * kTaps; e += kThreads) {
    const int o = e / kTaps, t = e - o * kTaps;
    ws[t * kRow + o] = w[e];
  }
  const float* xn = x + static_cast<int64_t>(n) * kC * H * W;
  for (int e = tid; e < kC * kIH * kIW; e += kThreads) {
    const int c = e / (kIH * kIW), rem = e - c * (kIH * kIW);
    const int ih = ih0 + rem / kIW, iw = iw0 + rem % kIW;
    int v = 0;
    if (ih >= 0 && ih < H && iw >= 0 && iw < W) {
      const float q = rintf(__fdiv_rn(
          __ldg(xn + (static_cast<int64_t>(c) * H + ih) * W + iw), scale));
      v = static_cast<int>(fminf(fmaxf(q, -128.f), 127.f));
    }
    xs[e] = v;
  }
  __syncthreads();

  // Conv outputs under the tile: warp = one group of 8 channels, lanes
  // walk the 9 x 17 positions.
  const int cg = tid / 32, lane = tid % 32;
  int b[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) b[j] = bias[cg * 8 + j];
  for (int p = lane; p < kCH * kCW; p += 32) {
    const int r = p / kCW, q = p - r * kCW;
    const int ch = ch0 + r, cw = cw0 + q;
    int acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = b[j];
    const bool valid = ch >= 0 && ch < Hc && cw >= 0 && cw < Wc;
    if (valid) {
      for (int c = 0; c < kC; ++c) {
        for (int kh = 0; kh < kK; ++kh) {
          const int* xrow = xs + (c * kIH + 2 * r + kh) * kIW + 2 * q;
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

  // Pool + requant: thread = one pooled pixel x 8 channels; eight
  // neighbouring threads write one pixel's 64 contiguous bytes.
  const int pp = tid / 8, og = tid % 8;
  const int pr = pp / kTPW, pc = pp % kTPW;
  const int ph = ph0 + pr, pw = pw0 + pc;
  if (ph >= Hp || pw >= Wp) return;
  int m[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) m[j] = -1;
  for (int dr = 0; dr < 3; ++dr)
    for (int dc = 0; dc < 3; ++dc) {
      const int* v = cs + ((2 * pr + dr) * kCW + 2 * pc + dc) * kRow + og * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) m[j] = max(m[j], v[j]);
    }
  int q[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) q[j] = requant_i8(m[j], factors[og * 8 + j]);
  int2 packed;
  packed.x = pack4(q[0], q[1], q[2], q[3]);
  packed.y = pack4(q[4], q[5], q[6], q[7]);
  *reinterpret_cast<int2*>(
      out + ((static_cast<int64_t>(n) * Hp + ph) * Wp + pw) * kO + og * 8) =
      packed;
}

}  // namespace

extern "C" int stem_fused_launch(const void* x, const void* w,
                                 const void* bias, const void* factors,
                                 void* out, int64_t N, int64_t H, int64_t W,
                                 int64_t Hp, int64_t Wp, float scale,
                                 void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      stem_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int Hc = static_cast<int>((H - 1) / 2 + 1);   // 7x7/s2/p3 conv
  const int Wc = static_cast<int>((W - 1) / 2 + 1);
  const dim3 grid(static_cast<unsigned>((Wp + kTPW - 1) / kTPW),
                  static_cast<unsigned>((Hp + kTPH - 1) / kTPH),
                  static_cast<unsigned>(N));
  stem_fused_kernel<<<grid, kThreads, kSmemBytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(w),
      static_cast<const int32_t*>(bias), static_cast<const float*>(factors),
      static_cast<int8_t*>(out), static_cast<int>(H), static_cast<int>(W),
      Hc, Wc, static_cast<int>(Hp), static_cast<int>(Wp), scale);
  return static_cast<int>(cudaGetLastError());
}
