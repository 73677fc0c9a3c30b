// K10: the ImageNet stem on int8 input -- 7x7/s2/p3 conv, bias, ReLU,
// then the 3x3/s2/p1 max pool on the accumulators and one requant
// (pooled), or a requant of every conv output (unpooled).
//
// Replaces resnet_accel_tpu/ops/fused_stem.py::_stem_pool_kernel and
// ::_stem_kernel (reached through fused_stem_pool, and the int8 input of
// the forward, fed by the loader of InferenceEngine.stream).  The TPU
// kernels ran the space-to-depth 4x4 conv as an im2col GEMM in VMEM with
// the pool's rows in the kernel and its columns outside; here the 7x7/s2
// conv runs directly and the whole pool stays in the tile.
//
// This is K1's tile without the quantize: the input is already int8, so a
// call reads 19 MB at batch 128 and 224 x 224 where K1 reads 77 MB of
// fp32.  The tile, its layout and what bounds it: stem_tile.cuh.

#include "stem_tile.cuh"

namespace {

template <bool kPool>
__global__ void __launch_bounds__(stem::kThreads)
stem_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const int32_t* __restrict__ bias,
                 const float* __restrict__ factors, int8_t* __restrict__ out,
                 int H, int W, int Hc, int Wc, int Ho, int Wo) {
  stem::stem_tile<int8_t, kPool>(x, w, bias, factors, out, H, W, Hc, Wc, Ho,
                                 Wo, 0.f);
}

template <bool kPool>
int launch(const void* x, const void* w, const void* bias,
           const void* factors, void* out, int64_t N, int64_t H, int64_t W,
           int64_t Ho, int64_t Wo, cudaStream_t stream) {
  constexpr size_t kSmem = stem::Tile<kPool>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      stem_int8_kernel<kPool>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  stem_int8_kernel<kPool><<<stem::grid<kPool>(N, Ho, Wo), stem::kThreads,
                            kSmem, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const int32_t*>(bias), static_cast<const float*>(factors),
      static_cast<int8_t*>(out), static_cast<int>(H), static_cast<int>(W),
      stem::conv_out(H), stem::conv_out(W), static_cast<int>(Ho),
      static_cast<int>(Wo));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int stem_int8_launch(const void* x, const void* w,
                                const void* bias, const void* factors,
                                void* out, int64_t N, int64_t H, int64_t W,
                                int64_t Ho, int64_t Wo, int64_t pool,
                                void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return pool ? launch<true>(x, w, bias, factors, out, N, H, W, Ho, Wo, s)
              : launch<false>(x, w, bias, factors, out, N, H, W, Ho, Wo, s);
}
