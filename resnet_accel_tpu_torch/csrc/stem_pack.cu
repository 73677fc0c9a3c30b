// K6: the input quantize fused with the 2x2 space-to-depth of the stem --
// fp32 [N, C, H, W] -> int8 [N, 4C, H/2, W/2], channel order (c,
// row-parity, col-parity), channels-last in memory ([N, H/2, W/2, 4C]
// physically, the layout the conv kernel K2 reads next).
//
// Replaces resnet_accel_tpu/ops/stem_pack.py::_kernel_nm (reached through
// quantize_s2d_nm) and ::_kernel_wh (quantize_s2d_wh, the same function
// with the spatial axes transposed).  The TPU kernels split the parities
// with sublane bitcasts and batch-minor views because Mosaic cannot lower
// lane-strided slices; on the card a thread simply reads the two input
// rows of its output pixel.
//
// Per output (n, c*4 + rp*2 + cp, i, j):
//   clip(rint(x[n, c, 2i + rp, 2j + cp] / scale), -128, 127)
// with the IEEE divide (__fdiv_rn) and rintf (ties to even), the golden
// quantize_input.
//
// What bounds it on the H100: it is pure data movement, 4 bytes read for
// each byte written (at batch 128 and 224 x 224: 77.07 MB in, 19.27 MB
// out, 0.0288 ms at 3.35 TB/s).  The design: one thread per output pixel
// (n, i, j), j fastest, so for each channel a warp's two float2 loads (rows
// 2i and 2i + 1, columns 2j and 2j + 1) cover 256 contiguous bytes of each
// row; the thread's four quantized values of a channel are one 4-byte word
// of its output pixel, stored as such.

#include <cuda_runtime.h>

#include <cstdint>

#include "epilogue.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
stem_pack_kernel(const float* __restrict__ x, int* __restrict__ out, int C,
                 int H, int W, int64_t pixels, float scale) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= pixels) return;
  const int Ho = H / 2, Wo = W / 2;
  const int j = static_cast<int>(p % Wo);
  const int i = static_cast<int>((p / Wo) % Ho);
  const int64_t n = p / (static_cast<int64_t>(Wo) * Ho);
  const float* xn = x + (n * C * H + 2 * i) * W + 2 * j;
  int* o = out + p * C;
  for (int c = 0; c < C; ++c) {
    const float* xc = xn + static_cast<int64_t>(c) * H * W;
    const float2 r0 = __ldg(reinterpret_cast<const float2*>(xc));
    const float2 r1 = __ldg(reinterpret_cast<const float2*>(xc + W));
    o[c] = pack4(quantize_i8(r0.x, scale), quantize_i8(r0.y, scale),
                 quantize_i8(r1.x, scale), quantize_i8(r1.y, scale));
  }
}

}  // namespace

extern "C" int stem_pack_launch(const void* x, void* out, int64_t N,
                                int64_t C, int64_t H, int64_t W, float scale,
                                void* stream) {
  const int64_t pixels = N * (H / 2) * (W / 2);
  if (pixels == 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((pixels + kThreads - 1) / kThreads);
  stem_pack_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int*>(out),
      static_cast<int>(C), static_cast<int>(H), static_cast<int>(W), pixels,
      scale);
  return static_cast<int>(cudaGetLastError());
}
