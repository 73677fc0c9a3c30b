// K4's conv route: the zero-skip int8 conv of a layer whose weight is held
// in small BSR blocks (at most 16 x 16: the reference's 14 x 14, 8 x 8),
// one launch a conv, with the patch gather as its prologue and the basic
// block's residual join as its epilogue.
//
// Replaces no TPU kernel.  The JAX package runs such a layer as im2col,
// then its BSR kernel, then the join; the port ran the same three stages
// (ops/conv.py::im2col_nchw, K4's small-block path, ops/epilogue.py::
// add_residual), and on the H100 the first and last held two thirds of the
// route's time: a patch matrix of up to 231 MB written and read back a
// layer, 24 eager join launches and their scalar uploads a batch (PERF.md).
// Here neither the patch matrix nor the pre-join tensor reaches device
// memory.
//
// Computes, for x [N, H, W, C] int8 channels-last and W [O, C * k * k] in
// CSR blocks over the (c, kh, kw) flattening (im2col_nchw's column order),
// per output pixel m (row of [N * Ho * Wo, O], channels-last) and channel n:
//   acc = sum over the stored blocks of im2col(x)[m, :] . W[n, :] (int32)
//   q   = clip(rint(f32(relu?(acc + bias[n])) * factors[n]), -128, 127)
//   with a residual r [N * Ho * Wo, O]:
//   q   = max(clip(rint((q * s_main + r * s_res) / s_out), -128, 127), 0)
// the golden's divide, as add_residual with no proven reciprocal.
//
// The walk (ops/bsr_conv.py::bsr_conv_plan picks the tile from the shape,
// ops/bsr_matmul.py::conv_walk orders the blocks once, at load):
// - A CTA owns an M tile of mt (64 or 128) output pixels and a run of at
//   most kMaxRows block rows; mt / 64 consumer warpgroups, 64 rows each,
//   and a producer warp.
// - Staging.  The consumers first copy into shared memory, by cp.async,
//   every input row the tile's windows cover, all C channels, channels-
//   last, with the zero padding (cp.async's zero fill): the tile in the
//   coordinates of the zero-padded input (of its every s-th row and column
//   for a 1 x 1 conv of stride s, which then walks it at stride 1), rows of
//   consecutive images back to back.  Each pixel's C bytes are followed by
//   ``chunk`` bytes of slack, so the eight consecutive pixels that a load
//   instruction gathers at once fall in eight different banks.  With them
//   the run's biases and factors, and the residual's bytes of the tile's
//   rows, which the epilogue reads.
// - The walk goes column by column: every block column that a row of the
//   run stores, with the mask of those rows.  The producer warp puts each
//   column's images through a ring of kRing slots under mbarriers, a slot
//   holding one image for every row of the run at its place, lane r
//   copying row r's by one bulk copy: K4's small-block images (ops.
//   bsr_matmul.small_stages: each block shifted into the 32-byte aligned K
//   window that holds it, zero elsewhere), the same stored blocks and the
//   same products as K4's small-block path, put at load in the walk's
//   order and in the 32-byte swizzle that the wgmma descriptors name (ops.
//   bsr_matmul.swizzle32), then a zero image, copied to each row that the
//   slot's last column stored and this one does not.  (A tensor copy of
//   each 16 x 32 image, a box 32 bytes wide, was slower.)
// - Building A.  For each column each consumer thread gathers its share of
//   the column's 32-byte window of the patch matrix once, straight into
//   the register fragment of wgmma (A from registers): two rows, eight K
//   columns each; then one wgmma.m64nNk32, N 16 for each row of the run
//   (kMaxRows x 8 accumulator registers), B the slot.  The gather table
//   (ops.bsr_conv.conv_gather_table, made once a geometry) maps K column
//   k = c * k * k + kh * k + kw to its byte in the staged tile relative to
//   the pixel's top-left tap; columns past K map to that tap itself, an
//   in-bounds byte that meets zero weights.  The next column's offsets are
//   loaded while this one's MMAs run.
// - Epilogue.  At the end of the run, for each of its rows: bias, ReLU,
//   requant (epilogue.cuh), then the residual join, stored straight into
//   the channels-last output, two channels a store where the layout
//   allows.
// The kernel never synchronizes with the host and allocates nothing.
//
// What bounds it on the H100: on the served ResNet-18 at batch 128 the
// layers' bound is their input and output bytes, the stored blocks, and
// their operations (0.18 ms over the 19 convs), far below the work a
// warpgroup does for each column: 16 byte loads from shared memory a
// thread behind their offsets, then an MMA over every row of the run,
// zeros included (1.7 to 2.4 of 5 to 8 rows store a column on ResNet-18
// at 0.7).  The kernel takes 4.3 ms over the 19 convs, about 400 SM
// cycles a column a warpgroup (PERF.md).  Two columns in flight in one
// warpgroup (the next window gathered while the MMAs run) gained nothing
// at 7 rows, and ptxas serialized the wgmmas at 5 and 8 rows for want of
// registers; one MMA for the whole run (N = 16 x rows) rather than one a
// row gained 8-13 % at tiles of 128 pixels, and copies issued by one lane
// held back tiles of 64, whose two warpgroups walk the columns at twice
// the rate.  So the design buys reuse and cover: the walk by column
// gathers a window once for every row of the run, one staging serves the
// whole run, runs of up to 5 rows take 3 CTAs an SM, and a tile of 64
// pixels splits its columns between two warpgroups.

#include <cuda_runtime.h>

#include <cstdint>

#include "epilogue.cuh"
#include "sm90_gemm_s8.cuh"

namespace {

constexpr int kWin = 32;                 // K bytes of a block's window
constexpr int kImg = 16 * kWin;          // a block's image: 16 x 32 bytes
constexpr int kMaxRows = 8;              // block rows a CTA walks at most
constexpr int kRing = 4;                 // columns' images in flight
constexpr int kChannels = 16 * kMaxRows; // output channels a CTA at most
constexpr int kResPitch = kChannels + 8; // bytes a staged residual row
constexpr int kWarpgroup = 128;
constexpr int kMaxThreads = 2 * kWarpgroup + 32;
// the alignment slack, the ring (a slot holds one image for each of the
// run's ``rows`` block rows), the ring's 2 * kRing mbarriers, the CTA's
// biases and factors: the staged tile starts head(rows) bytes into the
// dynamic shared memory at most
constexpr int head(int rows) {
  return 1024 + kRing * rows * kImg + 16 * kRing + 8 * kChannels;
}
// the second warpgroup's sums at 64 pixels, over the staged tile
constexpr int kPart = kMaxRows * 64 * 16 * 4;
constexpr int kMaxSmem = 232448;         // 227 KB, the H100's most a CTA
constexpr int kMaxDevices = 16;

struct Geom {
  const int8_t* x;           // [N, H, W, C] int8, channels-last
  const int32_t* row_ptr;    // [nbr + 1]: stored blocks of each block row
  const int32_t* walk_ptr;   // [runs + 1]: the columns of each run
  const int32_t* walk_col;   // column * 256 + the mask of its rows
  const int8_t* images;      // the walk's block images, swizzled
  const int32_t* tab;        // the gather table, by K column
  const int32_t* bias;       // [O]
  const float* factors;      // [O]
  const int8_t* res;         // [M, O] int8, or null
  int8_t* out;               // [M, O] int8
  int N, H, W, C, O, Ho, Wo;
  int ks, pad_h, pad_w;      // kernel side, top and left padding
  int ss, se;                // x's rows and columns a staged step; the
                             // conv's stride over the staged tile
  int Hs, Ws, P;             // staged rows an image, pixels a row, bytes
                             // a pixel (C and the slack)
  int chunk;                 // bytes a cp.async (and of the slack)
  int bh, bw, nbr;
  int mt, rows, runs;        // pixels an M tile, block rows a run, runs
  int stage_rows;            // staged rows of the largest tile
  int relu, pairs, res4;     // pairs: two channels a 2-byte store; res4:
                             // the residual's rows 4-byte aligned
  float s_main, s_res, s_out;
};

// ``chunk`` bytes from global ``src`` to shared ``dst``, or zeros.
__device__ __forceinline__ void cp_async(uint32_t dst, const int8_t* src,
                                         int chunk, bool ok) {
  const int n = ok ? chunk : 0;
  if (chunk == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(dst),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
                 "l"(src), "r"(n)
                 : "memory");
}

// D[64, 16 * kRows] += A[64, 32] . B[16 * kRows, 32]^T, s8 x s8 -> s32; A
// from registers (a[0]: row lane / 4, K bytes 4 * (lane % 4) ..; a[1]: row
// + 8; a[2], a[3]: the same rows at K + 16; rows 16 * warp of the
// warpgroup on), B in shared memory: kRows images back to back, one for
// each block row of a run.  d: register 8 * r + i is row r's i-th of the
// m64n16 fragment (``sm90::wgmma_n64``'s layout).
template <int kRows>
__device__ __forceinline__ void wgmma_rs(int (&d)[8 * kRows],
                                         const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<1>(int (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<2>(int (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<3>(int (&d)[24],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<4>(int (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<5>(int (&d)[40],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<6>(int (&d)[48],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<7>(int (&d)[56],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, {%56, %57, %58, %59}, %60, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<8>(int (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The four staged bytes at b + t.x .. b + t.w, the first lowest.
__device__ __forceinline__ uint32_t gather4(const uint8_t* tile, int b,
                                            int4 t) {
  return static_cast<uint32_t>(tile[b + t.x]) |
         (static_cast<uint32_t>(tile[b + t.y]) << 8) |
         (static_cast<uint32_t>(tile[b + t.z]) << 16) |
         (static_cast<uint32_t>(tile[b + t.w]) << 24);
}

// kRows: the block rows of a run (g.rows), each with its accumulator, all
// in one wgmma a column; at 5 or fewer the registers leave room for three CTAs an
// SM.
template <int kRows>
__global__ void __launch_bounds__(kMaxThreads, kRows <= 5 ? 3 : 2)
    bsr_conv_kernel(const Geom g) {
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle atoms' grid
  constexpr int kSlot = kRows * kImg;  // a column's images
  const uint32_t ring = base, full = base + kRing * kSlot,
                 empty = full + 8 * kRing,
                 epi = empty + 8 * kRing, tile_at = epi + 8 * kChannels;
  uint8_t* smem = smem_raw + (epi - raw);
  int* bias_s = reinterpret_cast<int*>(smem);
  float* fac_s = reinterpret_cast<float*>(smem + 4 * kChannels);
  const uint8_t* tile = smem + 8 * kChannels;
  const int pitch = g.Ws * g.P;
  const uint32_t res_at =
      tile_at + max((g.stage_rows * pitch + 15) & ~15,
                    g.mt == 64 ? kPart : 0);
  const uint8_t* res_s = tile + (res_at - tile_at);

  // two consumer warpgroups: of 128 pixels, 64 rows each; of 64, every
  // other column each, their sums added at the end
  const int consumers = 2 * kWarpgroup, split = g.mt == 64 ? 2 : 1;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = static_cast<int>(blockIdx.x / g.runs) * g.mt;
  const int run = static_cast<int>(blockIdx.x % g.runs);
  const int br0 = run * g.rows, br1 = min(br0 + g.rows, g.nbr);
  const int c_lo = __ldg(g.walk_ptr + run), c_hi = __ldg(g.walk_ptr + run + 1);

  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, consumers / 32 / split);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == consumers / 32) {
    // ---- the producer warp puts each column's images in its slot, each
    // row's at its place, lane r copying row r's: the stored ones, which
    // lie back to back in the walk's order, and the zero image after them
    // for each row that the slot's last column stored and this one does not
    // (for every row it does not store, at a slot's first use) ----
    const int8_t* src = g.images + static_cast<int64_t>(
                                       __ldg(g.row_ptr + br0)) * kImg;
    const int8_t* zeros = g.images + static_cast<int64_t>(
                                         __ldg(g.row_ptr + g.nbr)) * kImg;
    const uint32_t below = (1u << lane) - 1;  // the rows before lane's
    uint32_t held = 0xffffffffu;  // each slot's rows, 8 bits a slot
    int e = c_lo < c_hi ? __ldg(g.walk_col + c_lo) : 0;
    for (int c = c_lo; c < c_hi; ++c) {
      const int e_next = c + 1 < c_hi ? __ldg(g.walk_col + c + 1) : 0;
      const int slot = (c - c_lo) % kRing, phase = (c - c_lo) / kRing & 1;
      const uint32_t bar = full + 8 * slot;
      const int mask = e & 0xff;
      const int put = mask | (held >> (8 * slot) & ((1 << kRows) - 1));
      held = (held & ~(0xffu << (8 * slot))) | (mask << (8 * slot));
      mbar_wait(empty + 8 * slot, phase ^ 1);
      if (lane == 0) mbar_expect_tx(bar, __popc(put) * kImg);
      __syncwarp();
      if ((put >> lane) & 1)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
            "bytes [%0], [%1], %2, [%3];" ::"r"(ring + slot * kSlot +
                                                lane * kImg),
            "l"((mask >> lane) & 1 ? src + __popc(mask & below) * kImg
                                   : zeros),
            "r"(kImg), "r"(bar)
            : "memory");
      src += __popc(mask) * kImg;
      e = e_next;
    }
    return;
  }

  // ---- staging: the input rows of the tile's windows ----
  const int hw = g.Ho * g.Wo, M = g.N * hw;
  const int m_last = min(m0 + g.mt, M) - 1;
  auto staged_row = [&](int m) {
    const int n = m / hw;
    return n * g.Hs + (m - n * hw) / g.Wo * g.se;
  };
  const int r0 = staged_row(m0);
  const int nrows = staged_row(m_last) + g.ks - r0;
  const int per_pix = g.C / g.chunk, units = g.Ws * per_pix;
  for (int r = 0; r < nrows; ++r) {
    const int n = (r0 + r) / g.Hs;
    const int h = (r0 + r - n * g.Hs) * g.ss - g.pad_h;
    const bool row_ok = n < g.N && h >= 0 && h < g.H;
    const int8_t* xrow =
        g.x + (static_cast<int64_t>(n) * g.H + h) * g.W * g.C;
    for (int u = tid; u < units; u += consumers) {
      const int ws = u / per_pix, c = (u - ws * per_pix) * g.chunk;
      const int w = ws * g.ss - g.pad_w;
      const bool ok = row_ok && w >= 0 && w < g.W;
      cp_async(tile_at + r * pitch + ws * g.P + c,
               ok ? xrow + static_cast<int64_t>(w) * g.C + c : g.x, g.chunk,
               ok);
    }
  }
  // the epilogue's: the run's biases and factors, and the residual's
  // bytes [r_lo, r_hi) of the tile's rows
  const int n_lo = br0 * g.bh, n_hi = min(br1 * g.bh, g.O);
  const int r_lo = n_lo & ~3;
  if (g.res != nullptr) {
    const int span = min((n_hi + 3) & ~3, g.O) - r_lo;
    if (g.res4) {
      for (int u = tid; u < g.mt * (span / 4); u += consumers) {
        const int row = u / (span / 4), q = 4 * (u - row * (span / 4));
        const bool ok = m0 + row <= m_last;
        cp_async(res_at + row * kResPitch + q,
                 ok ? g.res + static_cast<int64_t>(m0 + row) * g.O + r_lo + q
                    : g.res,
                 4, ok);
      }
    } else {
      for (int u = tid; u < g.mt * span; u += consumers) {
        const int row = u / span, q = u - row * span;
        if (m0 + row <= m_last)
          const_cast<uint8_t*>(res_s)[row * kResPitch + q] =
              static_cast<uint8_t>(__ldg(
                  g.res + static_cast<int64_t>(m0 + row) * g.O + r_lo + q));
      }
    }
  }
  for (int i = tid; i < n_hi - n_lo; i += consumers) {
    bias_s[i] = __ldg(g.bias + n_lo + i);
    fac_s[i] = __ldg(g.factors + n_lo + i);
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  asm volatile("bar.sync 1, %0;" ::"r"(consumers) : "memory");

  // ---- the consumers: rows rl and rl + 8 of the tile a thread ----
  const int gq = lane / 4, tq = lane % 4;
  const int wg = warp / 4;
  const int rl = (split == 1 ? 64 * wg : 0) + 16 * (warp % 4) + gq;
  // a pixel's top-left tap in the staged tile (rows past M: the last's)
  auto tap0 = [&](int m) {
    m = min(m, m_last);
    const int n = m / hw, rem = m - n * hw, oh = rem / g.Wo;
    return (n * g.Hs + oh * g.se - r0) * pitch + (rem - oh * g.Wo) * g.se *
                                                     g.P;
  };
  const int b0 = tap0(m0 + rl), b1 = tap0(m0 + rl + 8);
  // this thread's gather offsets of the window of the column in entry e
  auto offsets = [&](int e, int4& lo, int4& hi) {
    const int4* t =
        reinterpret_cast<const int4*>(g.tab + (((e >> 8) * g.bw) & ~15));
    lo = __ldg(t + tq);
    hi = __ldg(t + 4 + tq);
  };

  int acc[8 * kRows];
#pragma unroll
  for (int i = 0; i < 8 * kRows; ++i) acc[i] = 0;
  const int c_first = c_lo + (split == 2 ? wg : 0);
  int4 lo, hi;
  if (c_first < c_hi) offsets(__ldg(g.walk_col + c_first), lo, hi);
  for (int c = c_first; c < c_hi; c += split) {
    const bool more = c + split < c_hi;
    const int e_next = more ? __ldg(g.walk_col + c + split) : 0;
    // the column's window, once for every row of the run
    uint32_t a[4];
    a[0] = gather4(tile, b0, lo);
    a[1] = gather4(tile, b1, lo);
    a[2] = gather4(tile, b0, hi);
    a[3] = gather4(tile, b1, hi);
    if (more) offsets(e_next, lo, hi);  // in flight while the MMAs run
    const int slot = (c - c_lo) % kRing, phase = (c - c_lo) / kRing & 1;
    mbar_wait(full + 8 * slot, phase);
    // one wgmma for every row of the run: the slot holds each row's image
    // of the column, zeros for a row that does not store it
    fence_acc(acc);
    wgmma_fence();
    wgmma_rs<kRows>(acc, a, smem_desc(ring + slot * kSlot, kWin, 3));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(empty + 8 * slot);
  }
  if (split == 2) {
    // the second warpgroup's sums, through the staged tile's space (the
    // host sizes it to hold them), into the first's
    int* part = reinterpret_cast<int*>(const_cast<uint8_t*>(tile));
    const int at = (16 * (warp % 4) + gq) * 16 + 2 * tq;
    asm volatile("bar.sync 1, %0;" ::"r"(consumers) : "memory");
    if (wg == 1) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<int2*>(part + r * 1024 + at + 8 * (i >> 1) +
                                   128 * (i & 1)) =
              make_int2(acc[8 * r + 2 * i], acc[8 * r + 2 * i + 1]);
    }
    asm volatile("bar.sync 1, %0;" ::"r"(consumers) : "memory");
    if (wg == 1) return;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int2 v = *reinterpret_cast<const int2*>(
            part + r * 1024 + at + 8 * (i >> 1) + 128 * (i & 1));
        acc[8 * r + 2 * i] += v.x;
        acc[8 * r + 2 * i + 1] += v.y;
      }
  }

  // ---- epilogue: bias, ReLU, requant and the join of each row's sums ----
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int br = br0 + r;
    if (br >= br1) break;
    const int n0 = br * g.bh, ncols = min(g.bh, g.O - n0);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = 8 * j + 2 * tq;
      if (c >= ncols) continue;
      const bool two = c + 1 < ncols, pair = two && g.pairs;
      const int n = n0 + c, i = n - n_lo;
      const int bias0 = bias_s[i], bias1 = two ? bias_s[i + 1] : 0;
      const float f0 = fac_s[i], f1 = two ? fac_s[i + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rl + 8 * h, m = m0 + row;
        if (m > m_last) continue;
        int v0 = acc[8 * r + 4 * j + 2 * h] + bias0,
            v1 = acc[8 * r + 4 * j + 2 * h + 1] + bias1;
        if (g.relu) {
          v0 = max(v0, 0);
          v1 = max(v1, 0);
        }
        int q0 = requant_i8(v0, f0), q1 = two ? requant_i8(v1, f1) : 0;
        if (g.res != nullptr) {
          const uint8_t* rv = res_s + row * kResPitch + (n - r_lo);
          q0 = residual_join(q0, static_cast<int8_t>(rv[0]), g.s_main,
                             g.s_res, g.s_out);
          if (two)
            q1 = residual_join(q1, static_cast<int8_t>(rv[1]), g.s_main,
                               g.s_res, g.s_out);
        }
        int8_t* o = g.out + static_cast<int64_t>(m) * g.O + n;
        if (pair) {
          *reinterpret_cast<uint16_t*>(o) =
              static_cast<uint16_t>((q0 & 0xff) | ((q1 & 0xff) << 8));
        } else {
          o[0] = static_cast<int8_t>(q0);
          if (two) o[1] = static_cast<int8_t>(q1);
        }
      }
    }
  }
}

}  // namespace

// One launch: m_tiles * runs CTAs of kMaxThreads threads, each staging
// stage_rows staged rows at most.
extern "C" int bsr_conv_launch(
    const void* x, const void* images, const void* row_ptr,
    const void* walk_ptr, const void* walk_col, const void* tab,
    const void* bias, const void* factors, const void* res, void* out,
    int64_t N, int64_t H, int64_t W, int64_t C, int64_t O, int64_t Ho,
    int64_t Wo, int64_t ks, int64_t pad_h, int64_t pad_w, int64_t ss,
    int64_t se, int64_t Hs, int64_t Ws, int64_t P, int64_t chunk,
    int64_t bh, int64_t bw, int64_t nbr, int64_t mt,
    int64_t rows, int64_t runs, int64_t stage_rows, int64_t relu,
    int64_t pairs, int64_t res4, float s_main, float s_res, float s_out,
    void* stream) {
  // the staged tile's space also takes, at 64 pixels, the second
  // warpgroup's sums
  const int64_t tile = (stage_rows * Ws * P + 15) & ~15,
                part = mt == 64 ? kPart : 0;
  const int64_t smem = head(static_cast<int>(rows)) +
                       (tile > part ? tile : part) +
                       (res != nullptr ? mt * kResPitch : 0);
  if ((mt != 64 && mt != 128) || bh > 16 || bw > 16 ||
      (chunk != 4 && chunk != 8) || C % chunk || P % chunk || rows < 1 ||
      rows > kMaxRows || runs < 1 || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  Geom g{};
  g.x = static_cast<const int8_t*>(x);
  g.row_ptr = static_cast<const int32_t*>(row_ptr);
  g.walk_ptr = static_cast<const int32_t*>(walk_ptr);
  g.walk_col = static_cast<const int32_t*>(walk_col);
  g.images = static_cast<const int8_t*>(images);
  g.tab = static_cast<const int32_t*>(tab);
  g.bias = static_cast<const int32_t*>(bias);
  g.factors = static_cast<const float*>(factors);
  g.res = static_cast<const int8_t*>(res);
  g.out = static_cast<int8_t*>(out);
  g.N = static_cast<int>(N);
  g.H = static_cast<int>(H);
  g.W = static_cast<int>(W);
  g.C = static_cast<int>(C);
  g.O = static_cast<int>(O);
  g.Ho = static_cast<int>(Ho);
  g.Wo = static_cast<int>(Wo);
  g.ks = static_cast<int>(ks);
  g.pad_h = static_cast<int>(pad_h);
  g.pad_w = static_cast<int>(pad_w);
  g.ss = static_cast<int>(ss);
  g.se = static_cast<int>(se);
  g.Hs = static_cast<int>(Hs);
  g.Ws = static_cast<int>(Ws);
  g.P = static_cast<int>(P);
  g.chunk = static_cast<int>(chunk);
  g.bh = static_cast<int>(bh);
  g.bw = static_cast<int>(bw);
  g.nbr = static_cast<int>(nbr);
  g.mt = static_cast<int>(mt);
  g.rows = static_cast<int>(rows);
  g.runs = static_cast<int>(runs);
  g.stage_rows = static_cast<int>(stage_rows);
  g.relu = static_cast<int>(relu);
  g.pairs = static_cast<int>(pairs);
  g.res4 = static_cast<int>(res4);
  g.s_main = s_main;
  g.s_res = s_res;
  g.s_out = s_out;
  void (*kernel)(const Geom) =
      rows == 1   ? bsr_conv_kernel<1>
      : rows == 2 ? bsr_conv_kernel<2>
      : rows == 3 ? bsr_conv_kernel<3>
      : rows == 4 ? bsr_conv_kernel<4>
      : rows == 5 ? bsr_conv_kernel<5>
      : rows == 6 ? bsr_conv_kernel<6>
      : rows == 7 ? bsr_conv_kernel<7>
                  : bsr_conv_kernel<8>;
  static bool sized[kMaxDevices][kMaxRows] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!sized[dev][rows - 1]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized[dev][rows - 1] = true;
  }
  const int64_t m_tiles = (N * Ho * Wo + mt - 1) / mt;
  kernel<<<static_cast<unsigned>(m_tiles * runs),
           static_cast<unsigned>(kMaxThreads), static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}
