// K1: the whole ImageNet stem in one pass -- quantize, 7x7/s2/p3 conv,
// bias, ReLU, 3x3/s2/p1 max pool and requant.
//
// Replaces resnet_accel_tpu/ops/stem_fused.py::_kernel (reached through
// stem_conv_pool_nm).  The TPU kernel regrouped the conv by space-to-depth
// into a 4x4 conv so the 128x128 MXU had work; that is bit-identical but
// buys nothing here, so this kernel computes the 7x7/s2 conv directly.
//
// x is the caller's fp32 images [N, 3, H, W]; each value is quantized as
// it is staged, clip(rint(x / scale), -128, 127) with the IEEE divide.
// The tile, its layout and what bounds it: stem_tile.cuh (pooled tile).
// At batch 128 and 224 x 224 the fp32 input (77 MB) is read about once and
// the pooled int8 output (26 MB) written once.

#include "stem_tile.cuh"

namespace {

__global__ void __launch_bounds__(stem::kThreads)
stem_fused_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                  const int32_t* __restrict__ bias,
                  const float* __restrict__ factors,
                  int8_t* __restrict__ out, int H, int W, int Hc, int Wc,
                  int Hp, int Wp, float scale) {
  stem::stem_tile<float, true>(x, w, bias, factors, out, H, W, Hc, Wc, Hp,
                               Wp, scale);
}

}  // namespace

extern "C" int stem_fused_launch(const void* x, const void* w,
                                 const void* bias, const void* factors,
                                 void* out, int64_t N, int64_t H, int64_t W,
                                 int64_t Hp, int64_t Wp, float scale,
                                 void* stream) {
  constexpr size_t kSmem = stem::Tile<true>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      stem_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  stem_fused_kernel<<<stem::grid<true>(N, Hp, Wp), stem::kThreads, kSmem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(w),
      static_cast<const int32_t*>(bias), static_cast<const float*>(factors),
      static_cast<int8_t*>(out), static_cast<int>(H), static_cast<int>(W),
      stem::conv_out(H), stem::conv_out(W), static_cast<int>(Hp),
      static_cast<int>(Wp), scale);
  return static_cast<int>(cudaGetLastError());
}
