// Shared int8 epilogues of the kernels, written to the numpy golden
// (resnet_accel_tpu/golden/ops.py): every float step is one IEEE f32
// operation with its own rounding (the _rn intrinsics, which nvcc never
// contracts into an FMA), ties round half to even (rintf), and results
// saturate to [-128, 127].
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

// clip(rint(float32(acc) * f), -128, 127) -- golden requantize.
__device__ __forceinline__ int requant_i8(int acc, float f) {
  float q = rintf(__fmul_rn(__int2float_rn(acc), f));
  return static_cast<int>(fminf(fmaxf(q, -128.f), 127.f));
}

// clip(rint(x / scale), -128, 127) with the IEEE divide -- golden
// quantize_input (a multiply by the reciprocal would round ties apart).
__device__ __forceinline__ int quantize_i8(float x, float scale) {
  const float q = rintf(__fdiv_rn(x, scale));
  return static_cast<int>(fminf(fmaxf(q, -128.f), 127.f));
}

// max(clip(rint((m*s_main + r*s_res) / s_out), -128, 127), 0) -- golden
// residual join of a basic block, with its post-add ReLU.
__device__ __forceinline__ int residual_join(int m, int r, float s_main,
                                             float s_res, float s_out) {
  float s = __fadd_rn(__fmul_rn(__int2float_rn(m), s_main),
                      __fmul_rn(__int2float_rn(r), s_res));
  float q = rintf(__fdiv_rn(s, s_out));
  q = fminf(fmaxf(q, -128.f), 127.f);
  return static_cast<int>(fmaxf(q, 0.f));
}

// residual_join with a multiply by ``inv_out`` in place of the divide by
// s_out: the same bits for every int8 pair wherever exact_inv_out_scale
// (ops/epilogue.py) returned inv_out for the block's scales.
__device__ __forceinline__ int residual_join_inv(int m, int r, float s_main,
                                                 float s_res, float inv_out) {
  float s = __fadd_rn(__fmul_rn(__int2float_rn(m), s_main),
                      __fmul_rn(__int2float_rn(r), s_res));
  float q = rintf(__fmul_rn(s, inv_out));
  q = fminf(fmaxf(q, -128.f), 127.f);
  return static_cast<int>(fmaxf(q, 0.f));
}

// Four int8 values, lowest address in the lowest byte (the __dp4a order).
__device__ __forceinline__ int pack4(int a, int b, int c, int d) {
  return static_cast<int>((static_cast<uint32_t>(a) & 0xffu) |
                          ((static_cast<uint32_t>(b) & 0xffu) << 8) |
                          ((static_cast<uint32_t>(c) & 0xffu) << 16) |
                          ((static_cast<uint32_t>(d) & 0xffu) << 24));
}

// Bytes [0, 16) of ``p`` as four words, each byte from ``n`` on zero: the
// masked tail of a K step in K4 and K8 when a block's width (or K) is not
// a multiple of 16.
__device__ __forceinline__ int4 load16_masked(const int8_t* p, int n) {
  int w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    int v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = 4 * q + j < n ? __ldg(p + 4 * q + j) : 0;
    w[q] = pack4(v[0], v[1], v[2], v[3]);
  }
  return make_int4(w[0], w[1], w[2], w[3]);
}
