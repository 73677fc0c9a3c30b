// K2: implicit-GEMM int8 convolution on the int8 tensor cores, with a
// fused requant epilogue and an optional fused residual join.
//
// Replaces resnet_accel_tpu/ops/conv_bm.py::_kernel_st (reached through
// conv3x3_bm_stacked, the stage-1 trunk of the TPU forward), and carries
// every other conv of the ResNet-18 trunk too -- the ones the TPU forward
// left to XLA's int8 convolution (ops/conv.py::conv2d_int8): 3x3 stride 1
// and 2, and the 1x1 stride-2 downsample convs.
//
// Layout: activations channels-last [N, H, W, C] int8 (the NCHW tensors of
// the Python side in torch.channels_last memory format), weights packed
// once at load as [O, KS, KS, C] int8, so the GEMM's K index runs
// (kh, kw, c) and a 4-byte word of input channels meets a 4-byte word of
// weights.  C and O must be multiples of 4.  The padding may differ by
// side (the space-to-depth stem's 4x4 conv pads 2 before and 1 after):
// the kernel takes the top and left pads, and the output size the caller
// gives sets the bottom and right ones.
//
// Per output (pixel p, channel o):
//   acc = sum_k x_patch[p, k] * w[o, k] + bias[o]   (int32, exact)
//   acc = relu(acc) if relu
//   q   = clip(rint(float(acc) * factors[o]), -128, 127)
//   with a residual r: q = max(clip(rint((q*s_main + r*s_res) / s_out)), 0)
//
// What bounds it on the H100: the ResNet-18 trunk at batch 128 is 217 G
// int8 multiply-adds over a few hundred MB of activations (each read nine
// times by a 3x3 gather, mostly from L2), so it is bound by arithmetic
// unless the arithmetic runs on the tensor cores.  The design answers that
// with mma.sync m16n8k32 (int8 in, int32 accumulate): a block computes a
// 128-pixel x 64-channel tile with 8 warps of 32 x 32, consuming K 32
// bytes per step.  The im2col matrix never exists in device memory: each
// step gathers its patch words straight from the input (zero for padding)
// into registers while the tensor cores work on the previous step's tile
// in shared memory (two stages).  When C is a multiple of 32 -- every conv
// of the trunk -- a step stays inside one (kh, kw) tap and each thread
// fetches 16 contiguous bytes of one pixel; other C take a word-by-word
// gather.  wgmma and TMA are the next step.

#include <cuda_runtime.h>

#include <cstdint>

#include "epilogue.cuh"
#include "mma_s8.cuh"

namespace {

constexpr int kBM = 128;    // output pixels per block
constexpr int kBN = 64;     // output channels per block
constexpr int kKW = 8;      // 4-byte K words per step (32 int8 values)
constexpr int kLd = 12;     // shared row stride in words: conflict-free
                            // fragment reads, 16-byte aligned rows
constexpr int kThreads = 256;

struct ConvGeom {
  int N, H, W, C, O, Ho, Wo, KS, stride, pad_h, pad_w;  // pad: top, left
};

// kVec: C % 32 == 0, so a K step of 8 words is one tap's 32 channels and
// every fetch is an aligned int4.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
conv_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const int32_t* __restrict__ bias,
                 const float* __restrict__ factors,
                 const int8_t* __restrict__ res, int8_t* __restrict__ out,
                 ConvGeom g, int relu, float s_main, float s_res,
                 float s_out) {
  __shared__ __align__(16) int As[2][kBM * kLd];   // [pixel][k word]
  __shared__ __align__(16) int Bs[2][kBN * kLd];   // [channel][k word]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int64_t M = static_cast<int64_t>(g.N) * g.Ho * g.Wo;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  const int Cw = g.C / 4;                 // channel words per pixel
  const int Kw = g.KS * g.KS * Cw;        // K words per output channel
  const int* x32 = reinterpret_cast<const int*>(x);
  const int* w32 = reinterpret_cast<const int*>(w);

  // Each thread fetches words [4*half, 4*half + 4) of every step for one
  // pixel (A) and, in the first half of the block, for one channel (B).
  const int half = tid % 2;
  const int am = tid / 2;                 // 0..127
  const int bn = tid / 2;                 // 0..127, < kBN fetches
  int pn = -1, ph = 0, pw = 0;            // the A pixel's image, origin
  {
    const int64_t gm = m0 + am;
    if (gm < M) {
      const int hw = g.Ho * g.Wo;
      const int r = static_cast<int>(gm % hw);
      pn = static_cast<int>(gm / hw);
      ph = (r / g.Wo) * g.stride - g.pad_h;
      pw = (r % g.Wo) * g.stride - g.pad_w;
    }
  }
  const int64_t img = static_cast<int64_t>(pn) * g.H;
  const bool b_live = bn < kBN && n0 + bn < g.O;
  const int* wrow = w32 + static_cast<int64_t>(n0 + bn) * Kw;

  // fetch(k0) -> ra, rb: the step's A and B words for this thread
  int4 ra, rb;
  int kh = 0, kw = 0, cw0 = 0;  // kVec: the tap and channel word of k0
  auto fetch = [&](int k0) {
    ra = make_int4(0, 0, 0, 0);
    rb = make_int4(0, 0, 0, 0);
    if (kVec) {
      const int ih = ph + kh, iw = pw + kw;
      if (pn >= 0 && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W)
        ra = __ldg(reinterpret_cast<const int4*>(
            x32 + ((img + ih) * g.W + iw) * Cw + cw0 + 4 * half));
      if (b_live)
        rb = __ldg(reinterpret_cast<const int4*>(wrow + k0 + 4 * half));
    } else {
      int va[4], vb[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kwd = k0 + 4 * half + j;
        va[j] = vb[j] = 0;
        if (kwd < Kw) {
          const int tap = kwd / Cw, c = kwd - tap * Cw;
          const int ih = ph + tap / g.KS, iw = pw + tap % g.KS;
          if (pn >= 0 && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W)
            va[j] = __ldg(x32 + ((img + ih) * g.W + iw) * Cw + c);
          if (b_live) vb[j] = __ldg(wrow + kwd);
        }
      }
      ra = make_int4(va[0], va[1], va[2], va[3]);
      rb = make_int4(vb[0], vb[1], vb[2], vb[3]);
    }
  };
  auto advance = [&]() {  // kVec: move (kh, kw, cw0) on by one step
    cw0 += kKW;
    if (cw0 == Cw) {
      cw0 = 0;
      if (++kw == g.KS) { kw = 0; ++kh; }
    }
  };
  auto stash = [&](int s) {
    *reinterpret_cast<int4*>(&As[s][am * kLd + 4 * half]) = ra;
    if (bn < kBN) *reinterpret_cast<int4*>(&Bs[s][bn * kLd + 4 * half]) = rb;
  };

  // Warp tile: rows wm..wm+31 (two m16), cols wn..wn+31 (four n8).
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int gq = lane / 4, tq = lane % 4;  // mma groupID, thread in group
  int acc[2][4][4] = {};

  fetch(0);
  stash(0);
  __syncthreads();
  int s = 0;
  for (int k0 = 0; k0 < Kw; k0 += kKW) {
    const bool more = k0 + kKW < Kw;
    if (more) {
      if (kVec) advance();
      fetch(k0 + kKW);  // in flight while the tensor cores run
    }
    const int* as = As[s];
    const int* bs = Bs[s];
    int a[2][4], b[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wm + 16 * i + gq;
      a[i][0] = as[r * kLd + tq];
      a[i][1] = as[(r + 8) * kLd + tq];
      a[i][2] = as[r * kLd + tq + 4];
      a[i][3] = as[(r + 8) * kLd + tq + 4];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = wn + 8 * j + gq;
      b[j][0] = bs[c * kLd + tq];
      b[j][1] = bs[c * kLd + tq + 4];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
    if (more) {
      stash(s ^ 1);  // the other stage: nobody reads it this step
      __syncthreads();
      s ^= 1;
    }
  }

  // Epilogue: acc[i][j] holds rows (r, r + 8) x cols (c, c + 1).
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = n0 + wn + 8 * j + 2 * tq;
    if (c >= g.O) continue;  // O % 4 == 0: both columns or neither
    const int b0 = bias[c], b1 = bias[c + 1];
    const float f0 = factors[c], f1 = factors[c + 1];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t gm = m0 + wm + 16 * i + gq + 8 * h;
        if (gm >= M) continue;
        int v0 = acc[i][j][2 * h] + b0, v1 = acc[i][j][2 * h + 1] + b1;
        if (relu) { v0 = max(v0, 0); v1 = max(v1, 0); }
        int q0 = requant_i8(v0, f0), q1 = requant_i8(v1, f1);
        const int64_t off = gm * g.O + c;
        if (res != nullptr) {
          q0 = residual_join(q0, res[off], s_main, s_res, s_out);
          q1 = residual_join(q1, res[off + 1], s_main, s_res, s_out);
        }
        out[off] = static_cast<int8_t>(q0);
        out[off + 1] = static_cast<int8_t>(q1);
      }
  }
}

}  // namespace

extern "C" int conv_int8_launch(const void* x, const void* w,
                                const void* bias, const void* factors,
                                const void* res, void* out, int64_t N,
                                int64_t H, int64_t W, int64_t C, int64_t O,
                                int64_t Ho, int64_t Wo, int64_t KS,
                                int64_t stride, int64_t pad_h,
                                int64_t pad_w, int64_t relu,
                                float s_main, float s_res, float s_out,
                                void* stream) {
  const ConvGeom g{static_cast<int>(N),  static_cast<int>(H),
                   static_cast<int>(W),  static_cast<int>(C),
                   static_cast<int>(O),  static_cast<int>(Ho),
                   static_cast<int>(Wo), static_cast<int>(KS),
                   static_cast<int>(stride), static_cast<int>(pad_h),
                   static_cast<int>(pad_w)};
  const int64_t M = N * Ho * Wo;
  const dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM),
                  static_cast<unsigned>((O + kBN - 1) / kBN));
  auto* kernel = (C % 32 == 0) ? conv_int8_kernel<true>
                               : conv_int8_kernel<false>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const int32_t*>(bias), static_cast<const float*>(factors),
      static_cast<const int8_t*>(res), static_cast<int8_t*>(out), g,
      static_cast<int>(relu), s_main, s_res, s_out);
  return static_cast<int>(cudaGetLastError());
}
