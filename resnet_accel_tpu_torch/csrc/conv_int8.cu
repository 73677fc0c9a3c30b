// K2: implicit-GEMM int8 convolution on the int8 tensor cores, with a
// fused requant epilogue and an optional fused residual join.
//
// Replaces resnet_accel_tpu/ops/conv_bm.py::_kernel_st (reached through
// conv3x3_bm_stacked, :565, the stage-1 trunk of the TPU forward), and
// carries every other conv of the ResNet trunks too -- the ones the TPU
// forward left to XLA's int8 convolution (ops/conv.py::conv2d_int8): 3x3
// stride 1 and 2, the 1x1 convs and the 1x1 stride-2 downsample convs.
//
// Layout: activations channels-last [N, H, W, C] int8 (the NCHW tensors of
// the Python side in torch.channels_last memory format), weights packed
// once at load as [O, KS, KS, C] int8, so the GEMM's K index runs
// (kh, kw, c).  The padding may differ by side (the space-to-depth stem's
// 4x4 conv pads 2 before and 1 after): the kernel takes the top and left
// pads, and the output size the caller gives sets the bottom and right.
//
// Per output (pixel p, channel o):
//   acc = sum_k x_patch[p, k] * w[o, k] + bias[o]   (int32, exact)
//   acc = relu(acc) if relu
//   q   = clip(rint(float(acc) * factors[o]), -128, 127)
//   with a residual r: q = max(clip(rint((q*s_main + r*s_res) / s_out)), 0)
//
// What bounds it on the H100: the ResNet-18 trunk at batch 128 is 217 G
// int8 multiply-adds (0.22 ms at the 1,979 TOP/s int8 peak) over 0.86 GB
// of activations, weights and outputs read and written once (0.26 ms at
// 3.35 TB/s): both bounds lie near each other, so it needs the tensor
// cores at a good share of their rate and each input byte fetched from
// device memory about once (a 3x3 window reads each pixel nine times,
// from L2 after the first).
//
// Two paths, chosen by the wrapper by shape (ops/conv.py::conv_plan):
//
// - The Hopper path (C % 32 == 0: every trunk conv of the ResNets and the
//   MNIST CNN's conv2) runs sm90_gemm_s8.cuh's main loop with kConv: M =
//   N * Ho * Wo output pixels, N = O, K = (kh, kw, c), and A never
//   materialised.  A tile is 128 pixels by 64 channels (O <= 64) or 128;
//   a K stage is one tap's bk channel bytes (128 where C % 128 == 0, else
//   64 or 32), so a 3x3 conv walks 9 * C / bk stages.  The producer warp
//   loads W's box through the tiled map K3 uses (W [O, KS*KS*C] is
//   K-major) and A's box through a TMA map in im2col mode over x: one
//   cp.async.bulk.tensor.4d.im2col a stage, at the tile's first window
//   and the stage's tap (kw, kh) as the im2col offsets; TMA walks the 128
//   pixels across row and image ends at the conv's stride and zero-fills
//   the padding, so the main loop has no masks.  Two consumer warpgroups
//   run wgmma.m64nBNk32.s32.s8.s8 from the swizzled stages; persistent
//   CTAs walk the tiles N tile fastest, so the CTAs at work share an A
//   tile in L2.  The epilogue is K3's (bias, ReLU, golden requant from the
//   accumulator fragments; with 64-wide tiles the tile leaves by one TMA
//   store), with the residual join read at the positions the tile stores.
//   Tiles are 64 channels wide unless the walk is long (K >= 2048) and O
//   >= 512: the TMA store's epilogue is the cheaper one, and at most
//   shapes the epilogue costs about what the main loop does.
// - The mma.sync path below (any other C % 4 == 0: the s2d stem's 4x4
//   conv at C = 12, the MNIST conv1): a block computes a 128-pixel x
//   64-channel tile with 8 warps of 32 x 32 on mma.sync m16n8k32, K 32
//   bytes a step; each step gathers its patch words one by one from the
//   input (zero for padding) into registers while the tensor cores work
//   on the previous step's tile in shared memory (two stages).
//
// conv_int8_launch picks the path from C alone.

#include <cuda_runtime.h>

#include <cstdint>

#include "epilogue.cuh"
#include "mma_s8.cuh"
#include "sm90_gemm_s8.cuh"

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
  auto fetch = [&](int k0) {
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
    if (more) fetch(k0 + kKW);  // in flight while the tensor cores run
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

// The Hopper path (C % 32 == 0), at N tile BN.
template <int BN>
cudaError_t launch_sm90(sm90::Params& p, cudaStream_t stream) {
  using namespace sm90;
  CUtensorMap map_a{}, map_w{}, map_out{};
  p.n_tiles = (p.N + BN - 1) / BN;
  cudaError_t err = make_out_map<BN>(&map_out, p, true);
  if (err == cudaSuccess) err = make_im2col_map(&map_a, p);
  if (err == cudaSuccess) err = make_map(&map_w, p.w, p.K, p.N, p.bk, BN, true);
  if (err == cudaSuccess)
    err = launch<BN, false, true, true>(map_a, map_w, map_out, p, stream);
  return err;
}

}  // namespace

// The path follows C (ops/conv.py::conv_plan): the Hopper path where C %
// 32 == 0, at N tile bn, 64 or 128 (ops/conv.py::conv_tile_n); else the
// mma.sync kernel, and bn must be 0.
extern "C" int conv_int8_launch(const void* x, const void* w,
                                const void* bias, const void* factors,
                                const void* res, void* out, int64_t N,
                                int64_t H, int64_t W, int64_t C, int64_t O,
                                int64_t Ho, int64_t Wo, int64_t KS,
                                int64_t stride, int64_t pad_h,
                                int64_t pad_w, int64_t relu, int64_t bn,
                                float s_main, float s_res, float s_out,
                                void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const int64_t M = N * Ho * Wo;
  if (C % 32 == 0) {
    if (M > INT32_MAX || KS * KS * C > INT32_MAX)
      return static_cast<int>(cudaErrorInvalidValue);
    sm90::Params p{};
    p.a = static_cast<const int8_t*>(x);
    p.w = static_cast<const int8_t*>(w);
    p.bias = static_cast<const int32_t*>(bias);
    p.factors = static_cast<const float*>(factors);
    p.out = out;
    p.M = static_cast<int>(M);
    p.N = static_cast<int>(O);
    p.K = static_cast<int>(KS * KS * C);
    p.bk = C % 128 == 0 ? 128 : C % 64 == 0 ? 64 : 32;
    p.layout = sm90::layout_of(p.bk);
    p.k_tiles = p.K / p.bk;
    p.split = 1;
    p.relu = static_cast<int>(relu);
    p.requant = 1;
    p.vec = 1;
    p.m_tiles = static_cast<int>((M + sm90::kBM - 1) / sm90::kBM);
    p.H = static_cast<int>(H);
    p.W = static_cast<int>(W);
    p.C = static_cast<int>(C);
    p.Ho = static_cast<int>(Ho);
    p.Wo = static_cast<int>(Wo);
    p.KS = static_cast<int>(KS);
    p.stride = static_cast<int>(stride);
    p.pad_h = static_cast<int>(pad_h);
    p.pad_w = static_cast<int>(pad_w);
    p.res = static_cast<const int8_t*>(res);
    p.s_main = s_main;
    p.s_res = s_res;
    p.s_out = s_out;
    if (bn == 64) return static_cast<int>(launch_sm90<64>(p, st));
    if (bn == 128) return static_cast<int>(launch_sm90<128>(p, st));
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bn != 0) return static_cast<int>(cudaErrorInvalidValue);
  const ConvGeom g{static_cast<int>(N),  static_cast<int>(H),
                   static_cast<int>(W),  static_cast<int>(C),
                   static_cast<int>(O),  static_cast<int>(Ho),
                   static_cast<int>(Wo), static_cast<int>(KS),
                   static_cast<int>(stride), static_cast<int>(pad_h),
                   static_cast<int>(pad_w)};
  const dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM),
                  static_cast<unsigned>((O + kBN - 1) / kBN));
  conv_int8_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const int32_t*>(bias), static_cast<const float*>(factors),
      static_cast<const int8_t*>(res), static_cast<int8_t*>(out), g,
      static_cast<int>(relu), s_main, s_res, s_out);
  return static_cast<int>(cudaGetLastError());
}
