// K1: the whole ImageNet stem in one pass -- quantize, 7x7/s2/p3 conv,
// bias, ReLU, 3x3/s2/p1 max pool and requant -- with the conv on the int8
// tensor cores.
//
// Replaces resnet_accel_tpu/ops/stem_fused.py::_kernel (reached through
// stem_conv_pool_nm).  Like the TPU kernel it regroups the conv by
// space-to-depth into a GEMM with K = 192.  The tile, its layout and its
// walk: stem_mma_tile.cuh, which K1 instantiates on fp32 input (quantized
// with the IEEE divide as it is staged), pooled.
//
// What bounds it: at batch 128 and 224 x 224 the 77 MB of fp32 input read
// once and the 26 MB output written once take 0.031 ms at 3.35 TB/s; the
// conv's 15.1 G multiply-adds take 0.015 ms at 1,979 TOP/s (the tiles'
// GEMMs do 22.5 G: the zero taps and the 1.14x edge recompute).  The
// staging (an IEEE divide a value, 1.5x over by the windows' overlap) and
// the pool are integer and FP32 issue.

#include "stem_mma_tile.cuh"

namespace {

__global__ void __launch_bounds__(stem_mma::kThreads, stem_mma::kCtasPerSm)
stem_fused_kernel(const float* __restrict__ x, const int* __restrict__ wp,
                  const int32_t* __restrict__ bias,
                  const float* __restrict__ factors,
                  int8_t* __restrict__ out, int H, int W, int Hc, int Wc,
                  int Hp, int Wp, int tiles_w, int tiles_img, int tiles,
                  float scale, bool pairs) {
  stem_mma::stem_tile<float, true>(x, wp, bias, factors, out, H, W, Hc, Wc,
                                   Hp, Wp, tiles_w, tiles_img, tiles, scale,
                                   pairs);
}

}  // namespace

// ctas: the persistent grid (ops/stem_fused.py::stem_plan), at most the
// tile count.
extern "C" int stem_fused_launch(const void* x, const void* wp,
                                 const void* bias, const void* factors,
                                 void* out, int64_t N, int64_t H, int64_t W,
                                 int64_t Hp, int64_t Wp, int64_t ctas,
                                 float scale, void* stream) {
  return stem_mma::launch<true>(stem_fused_kernel, x, wp, bias, factors, out,
                                N, H, W, Hp, Wp, ctas, scale, false,
                                static_cast<cudaStream_t>(stream));
}
