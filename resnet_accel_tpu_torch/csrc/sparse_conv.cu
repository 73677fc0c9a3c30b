// K8: zero-skip int8 convolution over tap-aligned BSR blocks, without
// im2col, any stride, with a fused bias / ReLU / requant epilogue.
//
// Replaces resnet_accel_tpu/ops/sparse_conv.py::_sconv_kernel (reached
// through sparse_conv2d_int8).  The TPU kernel kept phase planes of the
// input resident in VMEM and walked the blocks in scalar-prefetched
// chunks; those are Mosaic workarounds and are not carried over.
//
// Weights: a block is block_c input channels at one tap (kh, kw) by
// block_o output channels.  The stored blocks are grouped by output block
// ob as a CSR (o_ptr), each stored [block_o, block_c] int8, so a row of
// one output channel's weights is K-contiguous.  Activations are
// channels-last [N, H, W, C] int8 and the output is channels-last [N, Ho,
// Wo, c_out]: int8 with factors, int32 without.
//
// Per output (pixel p, channel o):
//   acc = sum over the stored blocks of ob(o), over their block_c channels
//         of x[n, ho*s + kh - pad, wo*s + kw - pad, cb*block_c + c] * w
//   acc = acc + bias[o]; acc = relu(acc)         if given
//   q   = clip(rint(float(acc) * factors[o]))    if factors is given
// An output block with no stored block still writes its epilogue.
//
// What bounds it on the H100: at the conv sweep's ResNet-18 shapes (batch
// 64, 30 % of the blocks stored) a call is about 2 G int8 operations on
// a few MB, so the bound is bytes, a few microseconds, and the kernel
// sits at launch and latency scale: it has to keep loads in flight and
// write whole sectors.
//
// Two routes, chosen by the wrapper by shape and alignment
// (ops/sparse_conv.py::sparse_conv_plan):
//
// - The Hopper route (block_c % 32 == 0, block_o % 8 == 0, x and the
//   blocks 16-byte aligned: the conv sweep's 128 x 128 blocks) runs
//   sm90_gemm_s8.cuh's main loop with both of its walks at once: K4's
//   stored-block walk (kBsr) over K2's conv windows (kConv).  The stored
//   blocks are a BSR weight over the conv's patch matrix in K2's K order
//   (kh, kw, c): output block ob is block row ob (row_ptr = o_ptr), block
//   i sits at block column col[i] = (kh * KS + kw) * (C / block_c) + cb,
//   and [nnz * block_o, block_c] is K4's weight layout as it stands.
//   The producer turns a stored block's K byte col * block_c + wx into
//   tap (kh, kw) and channel cb * block_c + wx, and fetches that window
//   slice with one TMA load in im2col mode (128 output pixels by bk
//   channels, the padding zero-filled) and the block's rows with a tiled
//   one, into a ring of stages; two consumer warpgroups run wgmma from
//   the stages; persistent CTAs walk the tiles output channels fastest,
//   so the tiles at work share their windows in L2.  A tile is 128
//   pixels by 64 channels of one output block (a 128-wide block is two
//   tiles, each walking the block's whole list): on the H100 that beat
//   one 128-wide tile a block at three sweep cases and tied at the
//   fourth (more tiles to spread over 132 SMs, and the int8 tile leaves
//   by one TMA store; PERF.md §6).  An output block that stores
//   no block walks no stage and writes its bias-only epilogue.  The
//   epilogue is bias, ReLU and the golden requant.  An int8 tile that
//   leaves by the TMA store (the sweep's) is rounded by K7's exact add of
//   1.5 * 2^23 (one conversion a value) and staged straight from the
//   accumulator fragments (no transpose across a quad; the epilogue is a
//   third of the time at the sweep's shapes); any other output is stored
//   from the fragments as K2's.  No split along K.
// - The mma.sync route below (any other block: the reference's (16, 14),
//   block_c 8; or an unaligned base): a CTA owns 128 output pixels by a
//   64-wide slice of one output block, walks that block's CSR list, and
//   for each 32-byte K step of a block gathers 16 contiguous bytes a
//   thread straight from the input at the tap's strided position (zero
//   outside the image) and the block's B rows, into two shared stages,
//   while the tensor cores (mma.sync m16n8k32, the code of mma_s8.cuh)
//   work on the other.  Any block_c that divides C and any block_o: the
//   B rows of a 64-wide slice past block_o are zero in shared memory and
//   the epilogue stores only the output block's own channels below
//   c_out.  A block's last K step is masked, its bytes past block_c zero:
//   16-byte loads for whole chunks at aligned bases, byte loads for the
//   rest.
//
// sparse_conv_launch takes the route the wrapper chose and refuses an N
// tile that does not fit it.

#include <cuda_runtime.h>

#include <cstdint>

#include "epilogue.cuh"
#include "mma_s8.cuh"
#include "sm90_gemm_s8.cuh"

namespace {

constexpr int kBM = 128;    // output pixels per block
constexpr int kBN = 64;     // output channels per block (of one ob)
constexpr int kKB = 32;     // K bytes per step
constexpr int kLd = 12;     // shared row stride in words: conflict-free
                            // fragment reads, 16-byte aligned rows
constexpr int kThreads = 256;

struct SconvGeom {
  int N, H, W, C, Ho, Wo, stride, pad, c_out, block_c, block_o, halves;
  int aligned;  // x and the blocks start on 16 bytes
};

template <bool kRequant>
__global__ void __launch_bounds__(kThreads, 2)
sparse_conv_kernel(const int8_t* __restrict__ x,
                   const int8_t* __restrict__ blocks,
                   const int* __restrict__ o_ptr, const int* __restrict__ kh_of,
                   const int* __restrict__ kw_of, const int* __restrict__ cb_of,
                   const int32_t* __restrict__ bias,
                   const float* __restrict__ factors, void* __restrict__ out,
                   SconvGeom g, int relu) {
  __shared__ __align__(16) int As[2][kBM * kLd];   // [pixel][k word]
  __shared__ __align__(16) int Bs[2][kBN * kLd];   // [channel][k word]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int64_t M = static_cast<int64_t>(g.N) * g.Ho * g.Wo;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int ob = blockIdx.y / g.halves;
  const int n_lo = (blockIdx.y % g.halves) * kBN;  // within the block
  const int n_cnt = min(kBN, g.block_o - n_lo);

  // Each thread fetches bytes [16*half, 16*half + 16) of every step for
  // one pixel (A) and, in the first half of the block, one channel (B).
  const int half = tid % 2;
  const int am = tid / 2;                 // 0..127
  const int bn = tid / 2;                 // < n_cnt fetches a B row
  int pn = -1, ph = 0, pw = 0;            // the A pixel's image, origin
  {
    const int64_t gm = m0 + am;
    if (gm < M) {
      const int hw = g.Ho * g.Wo;
      const int r = static_cast<int>(gm % hw);
      pn = static_cast<int>(gm / hw);
      ph = (r / g.Wo) * g.stride - g.pad;
      pw = (r % g.Wo) * g.stride - g.pad;
    }
  }
  const int64_t img = static_cast<int64_t>(pn) * g.H;
  const bool b_live = bn < n_cnt;

  const int j0 = o_ptr[ob];
  const int kps = (g.block_c + kKB - 1) / kKB;  // K steps per block
  const int steps = (o_ptr[ob + 1] - j0) * kps;

  // fetch(t) -> ra, rb: step t's A and B bytes for this thread
  int4 ra, rb;
  auto fetch = [&](int t) {
    const int j = j0 + t / kps;
    const int k0 = (t % kps) * kKB + 16 * half;
    ra = make_int4(0, 0, 0, 0);
    rb = make_int4(0, 0, 0, 0);
    const int ih = ph + __ldg(kh_of + j), iw = pw + __ldg(kw_of + j);
    const int n = min(16, g.block_c - k0);  // its bytes inside the block
    if (n <= 0) return;
    // a whole 16-byte chunk at a 16-byte aligned address: one load
    const bool v16 = n == 16 && g.block_c % 16 == 0 && g.aligned;
    if (pn >= 0 && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W) {
      const int8_t* p = x + ((img + ih) * g.W + iw) * g.C +
                        __ldg(cb_of + j) * g.block_c + k0;
      ra = v16 && g.C % 16 == 0 ? __ldg(reinterpret_cast<const int4*>(p))
                                : load16_masked(p, n);
    }
    if (b_live) {
      const int8_t* p =
          blocks + (static_cast<int64_t>(j) * g.block_o + n_lo + bn) *
                       g.block_c + k0;
      rb = v16 ? __ldg(reinterpret_cast<const int4*>(p))
               : load16_masked(p, n);
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

  if (steps > 0) {
    fetch(0);
    stash(0);
    __syncthreads();
  }
  int s = 0;
  for (int t = 0; t < steps; ++t) {
    const bool more = t + 1 < steps;
    if (more) fetch(t + 1);  // in flight while the tensor cores run
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
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = wn + 8 * j + 2 * tq + e;       // within the slice
      const int c = ob * g.block_o + n_lo + col;     // output channel
      if (col >= n_cnt || c >= g.c_out) continue;
      const int bc = bias != nullptr ? bias[c] : 0;
      const float f = kRequant ? factors[c] : 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int64_t gm = m0 + wm + 16 * i + gq + 8 * h;
          if (gm >= M) continue;
          int v = acc[i][j][2 * h + e] + bc;
          if (relu) v = max(v, 0);
          const int64_t off = gm * g.c_out + c;
          if (kRequant)
            static_cast<int8_t*>(out)[off] =
                static_cast<int8_t>(requant_i8(v, f));
          else
            static_cast<int32_t*>(out)[off] = v;
        }
    }
  }
}

// The Hopper route: the stored blocks of output block ob are block row ob
// of a BSR weight over the conv's patch matrix in the (kh, kw, c) K order,
// walked over x's im2col windows, in N tiles of 64 (kSub: ceil(block_o /
// 64) tiles an output block, each walking the block's whole list).
cudaError_t launch_sm90(sm90::Params& p, int64_t nnz, int64_t pixels,
                        cudaStream_t stream) {
  using namespace sm90;
  CUtensorMap map_a{}, map_w{}, map_out{};
  // a tile's 64-column box stays inside its output block unless a block
  // is not a multiple of 64 wide and more than one block is stored
  cudaError_t err =
      make_out_map<64>(&map_out, p, p.bh % 64 == 0 || p.N <= p.bh);
  if (err == cudaSuccess) err = make_im2col_map(&map_a, p);
  // the stored blocks as [nnz * block_o, block_c], boxes of 64 rows at a
  // block's first or a later 64; with none, a map over x as [N * H * W,
  // C] that nothing reads
  if (err == cudaSuccess)
    err = nnz > 0 ? make_map(&map_w, p.w, p.bw, nnz * p.bh, p.bk, 64, true)
                  : make_map(&map_w, p.a, p.C, pixels, p.bk, 64, true);
  if (err == cudaSuccess)
    err = launch<64, true, true, true>(map_a, map_w, map_out, p, stream);
  return err;
}

}  // namespace

// The route follows ops/sparse_conv.py::sparse_conv_plan: path 1, the
// Hopper route, at N tile bn 64; path 0, the mma.sync kernel, and bn must
// be 0.
extern "C" int sparse_conv_launch(
    const void* x, const void* blocks, const void* o_ptr, const void* kh,
    const void* kw, const void* cb, const void* col, const void* bias,
    const void* factors, void* out, int64_t N, int64_t H, int64_t W,
    int64_t C, int64_t Ho, int64_t Wo, int64_t KS, int64_t stride,
    int64_t pad, int64_t c_out, int64_t block_c, int64_t block_o,
    int64_t n_ob, int64_t nnz, int64_t relu, int64_t path, int64_t bn,
    void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const int64_t M = N * Ho * Wo;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(blocks) % 16 == 0;
  if (path == 1) {
    if (block_c % 32 || block_o % 8 || !aligned || bn != 64 ||
        M > INT32_MAX || KS * KS * C > INT32_MAX)
      return static_cast<int>(cudaErrorInvalidValue);
    sm90::Params p{};
    p.a = static_cast<const int8_t*>(x);
    p.w = static_cast<const int8_t*>(blocks);
    p.row_ptr = static_cast<const int32_t*>(o_ptr);
    p.col_idx = static_cast<const int32_t*>(col);
    p.bias = static_cast<const int32_t*>(bias);
    p.factors = static_cast<const float*>(factors);
    p.out = out;
    p.M = static_cast<int>(M);
    p.N = static_cast<int>(c_out);
    p.K = static_cast<int>(KS * KS * C);
    p.bk = block_c % 128 == 0 ? 128 : block_c % 64 == 0 ? 64 : 32;
    p.layout = sm90::layout_of(p.bk);
    p.bh = static_cast<int>(block_o);
    p.bw = static_cast<int>(block_c);
    p.n_tiles = static_cast<int>(n_ob * ((block_o + 63) / 64));
    p.m_tiles = static_cast<int>((M + sm90::kBM - 1) / sm90::kBM);
    p.split = 1;
    p.vec = 1;
    p.relu = static_cast<int>(relu);
    p.requant = factors != nullptr;
    p.H = static_cast<int>(H);
    p.W = static_cast<int>(W);
    p.C = static_cast<int>(C);
    p.Ho = static_cast<int>(Ho);
    p.Wo = static_cast<int>(Wo);
    p.KS = static_cast<int>(KS);
    p.stride = static_cast<int>(stride);
    p.pad_h = p.pad_w = static_cast<int>(pad);
    return static_cast<int>(launch_sm90(p, nnz, N * H * W, st));
  }
  if (path != 0 || bn != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int halves = static_cast<int>((block_o + kBN - 1) / kBN);
  const SconvGeom g{static_cast<int>(N),       static_cast<int>(H),
                    static_cast<int>(W),       static_cast<int>(C),
                    static_cast<int>(Ho),      static_cast<int>(Wo),
                    static_cast<int>(stride),  static_cast<int>(pad),
                    static_cast<int>(c_out),   static_cast<int>(block_c),
                    static_cast<int>(block_o), halves,
                    static_cast<int>(aligned)};
  const dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM),
                  static_cast<unsigned>(n_ob * halves));
  auto* kernel = factors != nullptr ? sparse_conv_kernel<true>
                                     : sparse_conv_kernel<false>;
  kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(blocks),
      static_cast<const int*>(o_ptr), static_cast<const int*>(kh),
      static_cast<const int*>(kw), static_cast<const int*>(cb),
      static_cast<const int32_t*>(bias), static_cast<const float*>(factors),
      out, g, static_cast<int>(relu));
  return static_cast<int>(cudaGetLastError());
}
