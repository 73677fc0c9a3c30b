// K10: the ImageNet stem on int8 input -- 7x7/s2/p3 conv, bias, ReLU,
// then the 3x3/s2/p1 max pool on the accumulators and one requant
// (pooled), or a requant of every conv output (unpooled) -- with the conv
// on the int8 tensor cores.
//
// Replaces resnet_accel_tpu/ops/fused_stem.py::_stem_pool_kernel and
// ::_stem_kernel (reached through fused_stem_pool, and the int8 input of
// the forward, fed by the loader of InferenceEngine.stream).  The TPU
// kernels ran the space-to-depth 4x4 conv as an im2col GEMM in VMEM with
// the pool's rows in the kernel and its columns outside; here the whole
// pool stays in the tile.
//
// This is K1's tile without the quantize (stem_mma_tile.cuh: the tile,
// its layout and its walk): the window is staged from int8 bytes, two
// 16-bit row loads a word where W is even.  Pooled, it is K1's 7 x 8
// tile; unpooled, disjoint 16 x 16 conv tiles with the requantized int8
// tile stored from shared memory in 16-byte vectors.
//
// What bounds it, at batch 128 and 224 x 224: pooled, the conv's 15.1 G
// multiply-adds at 1,979 TOP/s, 0.015 ms (the 19 MB of input and 26 MB of
// output take 0.013 ms at 3.35 TB/s); unpooled, the 19 MB read and the
// 103 MB written, 0.036 ms (its GEMMs' 19.7 G multiply-adds take 0.020
// ms).  On mma.sync at the 585-662 TOP/s the probes measure, the GEMMs
// alone take 0.07 ms; the staging, the epilogues and their serial order in
// a tile add to that.

#include "stem_mma_tile.cuh"

namespace {

template <bool kPool>
__global__ void __launch_bounds__(stem_mma::kThreads, stem_mma::kCtasPerSm)
stem_int8_kernel(const int8_t* __restrict__ x, const int* __restrict__ wp,
                 const int32_t* __restrict__ bias,
                 const float* __restrict__ factors, int8_t* __restrict__ out,
                 int H, int W, int Hc, int Wc, int Ho, int Wo, int tiles_w,
                 int tiles_img, int tiles, float scale, bool pairs) {
  stem_mma::stem_tile<int8_t, kPool>(x, wp, bias, factors, out, H, W, Hc, Wc,
                                     Ho, Wo, tiles_w, tiles_img, tiles, scale,
                                     pairs);
}

}  // namespace

// wp: the packed [64, 192] weight; ctas: the persistent grid
// (ops/stem_fused.py::stem_plan for ``pool``), at most the tile count.
extern "C" int stem_int8_launch(const void* x, const void* wp,
                                const void* bias, const void* factors,
                                void* out, int64_t N, int64_t H, int64_t W,
                                int64_t Ho, int64_t Wo, int64_t ctas,
                                int64_t pool, void* stream) {
  // 16-bit row loads need every pair's address even: W even, x aligned
  const bool pairs = W % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 2 == 0;
  auto s = static_cast<cudaStream_t>(stream);
  return pool ? stem_mma::launch<true>(stem_int8_kernel<true>, x, wp, bias,
                                       factors, out, N, H, W, Ho, Wo, ctas,
                                       0.f, pairs, s)
              : stem_mma::launch<false>(stem_int8_kernel<false>, x, wp, bias,
                                        factors, out, N, H, W, Ho, Wo, ctas,
                                        0.f, pairs, s);
}
