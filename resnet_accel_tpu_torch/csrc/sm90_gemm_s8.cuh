// The Hopper main loop shared by K3 (csrc/matmul_int8.cu, dense), K4
// (csrc/bsr_matmul.cu, block-sparse), K2 (csrc/conv_int8.cu, the conv
// as an implicit GEMM), K7 (csrc/expand_add.cu, a 1x1 conv joined to
// its residual) and K8 (csrc/sparse_conv.cu, the zero-skip conv: K4's
// walk over K2's windows, kBsr and kConv at once).  All compute
//   C[M, N] = A[M, K] @ W^T   for int8 A [M, K] and W [N, K], K-major
//   acc = sum (int32, exact) + bias[n];  acc = relu(acc) if relu
//   out = requant ? clip(rint(f32(acc) * factors[n]), -128, 127) : acc
// and differ in the K tiles a CTA walks -- every tile of K for K3, K2 and
// K7, the stored blocks of one block row for K4 -- and in A: a matrix for
// K3, K4 and K7; for K2 (kConv) the conv windows of x [N, H, W, C], which
// a TMA map in im2col mode fetches a tap at a time (make_im2col_map), with
// the residual join (epilogue.cuh) fused into the stores.  K7 (kExpand)
// requantizes without ReLU and joins the residual p.res in an epilogue of
// its own (join_tile), exact without a conversion instruction.
//
// A tile is 128 rows of M by BN columns of N (K4: one block row; K8: BN
// columns of one, walking the block row's blocks):
// - TMA.  The host encodes a tensor map over A [M, K] and one over the
//   weight rows (cuTensorMapEncodeTiled, fetched through
//   cudaGetDriverEntryPoint, so the library links without -lcuda), boxes
//   of bk K bytes (128, 64 or 32, each with the swizzle of its width) by
//   128 or BN rows.  TMA zero-fills past the tensor's end, so ragged M, N
//   and K need no mask in the main loop.
// - Pipeline.  A ring of kStages stages with a full and an empty mbarrier
//   each.  One producer warp (one lane issues the copies) runs ahead; two
//   consumer warpgroups, 64 rows each, issue wgmma.m64nBNk32.s32.s8.s8 on
//   both operands in shared memory through descriptors that name the same
//   swizzle, keep one commit group in flight and free a stage once the
//   group that read it has retired.
// - Persistent CTAs.  Without a split, the grid is as many CTAs as the
//   card holds at once, each walking tiles gridDim.x apart; the ring and
//   its phases run on across tiles, so the producer loads the next tile
//   while the consumers store this one.  The consumers store straight from
//   their accumulator fragments, a quad of lanes 32 contiguous bytes of a
//   row (int8 columns transposed across the quad by shuffles); at BN 64 an
//   int8 tile is staged instead over the W half of its last stage and
//   leaves by one TMA store.  Bias and factors come through the read-only
//   path, once a column.  The A map fetches only the box's bytes into L2
//   for K4 (the next block column of a row is often not stored), 256
//   bytes around it for dense walks.
// - Split-K.  With a split, the CTAs of a thread-block cluster (2 to 8,
//   along K) each sum a share of one tile's K units in int32 and stage the
//   partial in their shared memory.  After a cluster barrier, rank r adds
//   the partials of rows [r * 128 / split, (r + 1) * 128 / split) from
//   every rank through distributed shared memory, runs their epilogue and
//   writes each row in stores of the widest width (16 bytes down to 1) its
//   pitch allows.  One launch, no workspace, no atomics, and the same bits
//   for every split: the sum is an integer sum.  The wrappers split only
//   long walks, by two (see _kernels.cluster_split: larger clusters cost
//   more than they save on the H100).
// - The staged variant (kTma false, K3 only) fills the same swizzled
//   stages from the producer warp with 16-byte or masked byte loads, for
//   the shapes TMA refuses: K % 16 != 0 or a base off 16 bytes.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "epilogue.cuh"

namespace sm90 {
namespace {

constexpr int kBM = 128;                   // A rows a CTA
constexpr int kBK = 128;                   // K bytes a stage, at most
constexpr int kConsumers = 256;            // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kMaxSplit = 8;               // portable cluster size
constexpr int kMaxDevices = 16;            // devices whose residency is kept

// K7's join, a template argument of gemm_s8_kernel: none (K2, K3, K4), by
// the IEEE divide by s_out, or by the multiply by p.inv_out that
// exact_inv_out_scale (ops/epilogue.py) proved equal to it on all 256 x 256
// int8 pairs of the block's scales.  The host picks by whether it has the
// proof.
enum Expand { kNoExpand = 0, kExpandDiv = 1, kExpandInv = 2 };

template <int BN, int kExpand = kNoExpand>
struct Cfg {
  // K7 (kExpand, BN 128) keeps two residual tiles beside the ring: two
  // stages, so that two CTAs still fit an SM
  static constexpr int kStages = kExpand ? 2 : BN <= 64 ? 4 : 3;
  static constexpr int kA = kBM * kBK;      // bytes of an A stage
  static constexpr int kW = BN * kBK;       // bytes of a W stage
  static constexpr int kRing = kStages * (kA + kW);
  static constexpr int kLd = BN + 8;        // int32s a staged row
  static_assert(kExpand || kBM * kLd * 4 <= kRing,
                "the staged partial reuses the ring");
  static constexpr int kRes = kBM * BN;     // K7: bytes of a residual tile
  static_assert(!kExpand || BN == 128, "K7's tile is one 128-byte box wide");
  // the ring (aligned to 1024 bytes by hand), then 2 * kStages mbarriers;
  // K7: two more, and from the next 1024-byte boundary two residual tiles
  static constexpr int kSmem =
      1024 + kRing + (kExpand ? 1024 + 2 * kRes : 16 * kStages);
  static constexpr int kMinBlocks = BN <= 128 ? 2 : 1;  // CTAs an SM
  // An int8 tile leaves by TMA store at BN 64 only: on the H100 it made
  // the stage-1 convs' K4 15 % faster, but wider tiles 10-20 % slower
  // (the staging's two barriers, and registers spilled at two CTAs an SM)
  // than the fragment stores (kernel_ab.py --splits; PERF.md §6).
  static constexpr bool kTmaOut = BN == 64;
};

struct Params {
  const int8_t* a;         // A [M, K] (read directly by the staged variant)
  const int8_t* w;         // W [N, K] (likewise)
  const int32_t* row_ptr;  // K4: block row br holds blocks [row_ptr[br],
  const int32_t* col_idx;  //   row_ptr[br + 1]), each at block column col_idx
  const int32_t* bias;     // [N] or null
  const float* factors;    // [N] when requant
  void* out;               // [M, N]: int8 when requant, else int32
  int M, N, K;
  int bk, layout;          // K bytes a stage; its wgmma swizzle code
  int k_tiles;             // K3: bk-byte tiles over K
  int bh, bw;              // K4: the block shape
  int n_tiles, m_tiles;    // tiles along N (K4: block rows) and M
  int split;               // CTAs of a cluster, along K
  int vec;                 // bytes a store
  int relu, requant;
  int tma_out;             // int8 tiles leave by TMA store (map_out)
  // K2 (kConv): A is the conv window of x [N, H, W, C] channels-last
  // (p.a), K runs (kh, kw, c), pads are the top and left ones
  int H, W, C, Ho, Wo, KS, stride, pad_h, pad_w;
  const int8_t* res;       // K2, K7: the residual [M, N] int8 to join
  float s_main, s_res, s_out;
  float inv_out;           // K7 (kExpandInv): the proven reciprocal of s_out
};

// Rank ``rank`` of ``split`` walks units [lo, lo + cnt) of n (K tiles or
// stored blocks): ops' split_share in _kernels.py is the same formula.
__host__ __device__ __forceinline__ void split_share(int n, int split,
                                                     int rank, int& lo,
                                                     int& cnt) {
  const int per = (n + split - 1) / split;
  lo = rank * per < n ? rank * per : n;
  cnt = (lo + per < n ? lo + per : n) - lo;
}

// ---- PTX ----------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity ``parity`` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// The box of ``map`` at (x, y) (x: K bytes, y: rows) into shared ``dst``;
// completion (the box's bytes) is reported to ``bar``.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// K2's A box: pixelsPerColumn pixels of the im2col map, the first at input
// coordinates (w, h, n), each one's channels [c, c + channelsPerPixel) at
// tap offset (ow, oh); TMA walks the pixels across row and image ends at
// the map's stride and zero-fills what lies outside x (the padding).
__device__ __forceinline__ void tma_load_im2col(uint32_t dst,
                                                const CUtensorMap* map, int c,
                                                int w, int h, int n, int ow,
                                                int oh, uint32_t bar) {
  const uint16_t ow16 = static_cast<uint16_t>(ow),
                 oh16 = static_cast<uint16_t>(oh);
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6], {%7, %8};" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(w), "r"(h), "r"(n),
      "r"(bar), "h"(ow16), "h"(oh16)
      : "memory");
}

// The box of ``map`` at (x, y) from shared ``src`` (laid out as the map's
// swizzle places it), in the current bulk group; past the tensor's end
// nothing is written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, int x,
                                          int y, uint32_t src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%1, %2}], [%3];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(x), "r"(y), "r"(src)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Until every committed bulk group has read its shared source.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// Until every committed bulk group has completed its writes.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_n(uint32_t bar, int n) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(n)
               : "memory");
}

// wgmma shared-memory descriptor of a K-major tile whose rows are bk bytes
// (one swizzle atom wide), 8-row groups 8 * bk bytes apart; ``layout`` is
// the swizzle code (1: 128 bytes, 2: 64, 3: 32) that the tensor map used.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, int bk,
                                              int layout) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (1ull << 16) |
         (static_cast<uint64_t>((8 * bk) >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Pins the accumulator to its registers across the asynchronous wgmmas, so
// that the compiler moves none of them while a group is in flight.
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending)
               : "memory");
}

// D[64, N] += A[64, 32] . B[N, 32]^T, s8 x s8 -> s32, both operands in
// shared memory.  d: the warpgroup's accumulator fragment, N / 2 int32s a
// thread (register 4j + e: row 16 * warp + lane / 4 + 8 * (e / 2), column
// 8j + 2 * (lane % 4) + e % 2).
__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
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
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n256(int (&d)[128], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
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
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma(int (&d)[BN / 2], uint64_t da,
                                      uint64_t db) {
  if constexpr (BN == 64)
    wgmma_n64(d, da, db);
  else if constexpr (BN == 128)
    wgmma_n128(d, da, db);
  else
    wgmma_n256(d, da, db);
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;" ::: "memory");
}

// Four int32s at shared address ``addr`` of the cluster's CTA ``rank``.
__device__ __forceinline__ int4 ld_cluster(uint32_t addr, int rank) {
  uint32_t remote;
  int4 v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// Bytes [k, k + 16) of a row of ``len`` bytes, zero from len on.
__device__ __forceinline__ int4 load_row16(const int8_t* row, int k,
                                           int len) {
  if (k + 16 <= len && (reinterpret_cast<uintptr_t>(row + k) & 15) == 0)
    return __ldg(reinterpret_cast<const int4*>(row + k));
  return load16_masked(row + k, len - k);
}

// K2: the input coordinates of output pixel m's top-left tap.
struct Pixel {
  int n, h, w;
};

__device__ __forceinline__ Pixel pixel_of(const Params& p, int m) {
  const int hw = p.Ho * p.Wo, n = m / hw, r = m - n * hw, oh = r / p.Wo;
  return {n, oh * p.stride - p.pad_h, (r - oh * p.Wo) * p.stride - p.pad_w};
}

// v[4g .. 4g + 3] = t, or += t.
__device__ __forceinline__ void put4(int (&v)[16], int g, int4 t, bool add) {
  v[4 * g] = (add ? v[4 * g] : 0) + t.x;
  v[4 * g + 1] = (add ? v[4 * g + 1] : 0) + t.y;
  v[4 * g + 2] = (add ? v[4 * g + 2] : 0) + t.z;
  v[4 * g + 3] = (add ? v[4 * g + 3] : 0) + t.w;
}

// ``bytes`` bytes of ``w`` (16 int32 words, or 4 words of packed int8) to
// ``dst`` in stores of ``vec`` bytes; a store whose first byte is at or
// past ``valid`` is left out.
__device__ __forceinline__ void store_unit(uint8_t* dst,
                                           const uint32_t (&w)[16],
                                           int bytes, int valid, int vec) {
  if (vec == 16) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (16 * i < bytes && 16 * i < valid)
        *reinterpret_cast<uint4*>(dst + 16 * i) =
            make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
  } else if (vec == 8) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (8 * i < bytes && 8 * i < valid)
        *reinterpret_cast<uint2*>(dst + 8 * i) =
            make_uint2(w[2 * i], w[2 * i + 1]);
  } else if (vec == 4) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (4 * i < bytes && 4 * i < valid)
        *reinterpret_cast<uint32_t*>(dst + 4 * i) = w[i];
  } else if (vec == 2) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (2 * i < bytes && 2 * i < valid)
        *reinterpret_cast<uint16_t*>(dst + 2 * i) =
            static_cast<uint16_t>(w[i / 2] >> (16 * (i % 2)));
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (i < bytes && i < valid)
        dst[i] = static_cast<uint8_t>(w[i / 4] >> (8 * (i % 4)));
  }
}

// ---- the kernel -----------------------------------------------------------

// One tile's walk: its output columns, its rows, and the stages of bk K
// bytes that this rank sums.
struct Walk {
  int n0, ncols, m0;  // first output column, columns held, first A row
  int first, nsteps;  // this rank's units, as stages from ``first``
  int blk0, sub;      // K4: the block row's first block; stages a block
};

// kSub (K8): a block row is ceil(bh / BN) tiles of BN columns, each
// walking the whole block row (p.n_tiles counts tiles, not block rows); a
// tile past N walks nothing and stores nothing.
template <int BN, bool kBsr, bool kSub = false>
__device__ __forceinline__ Walk walk_of(const Params& p, int tile, int rank) {
  Walk wk;
  const int tile_n = tile % p.n_tiles;
  wk.m0 = (tile / p.n_tiles) * kBM;
  wk.sub = 1;
  wk.blk0 = 0;
  if constexpr (kSub) {
    const int n_sub = (p.bh + BN - 1) / BN, br = tile_n / n_sub;
    const int s0 = (tile_n - br * n_sub) * BN;  // the tile's first column
    wk.n0 = br * p.bh + s0;
    wk.ncols = min(min(BN, p.bh - s0), p.N - wk.n0);
    wk.blk0 = p.row_ptr[br];
    split_share(p.row_ptr[br + 1] - wk.blk0, p.split, rank, wk.first,
                wk.nsteps);
    wk.sub = p.bw / p.bk;
    wk.nsteps = wk.ncols > 0 ? wk.nsteps * wk.sub : 0;
  } else if constexpr (kBsr) {
    wk.n0 = tile_n * p.bh;
    wk.ncols = min(p.bh, p.N - wk.n0);
    wk.blk0 = p.row_ptr[tile_n];
    split_share(p.row_ptr[tile_n + 1] - wk.blk0, p.split, rank, wk.first,
                wk.nsteps);
    wk.sub = p.bw / p.bk;
    wk.nsteps *= wk.sub;
  } else {
    wk.n0 = tile_n * BN;
    wk.ncols = min(BN, p.N - wk.n0);
    split_share(p.k_tiles, p.split, rank, wk.first, wk.nsteps);
  }
  return wk;
}

// The bias and requant factor of output column n, through the read-only
// path: they cannot alias the output, so their loads run ahead of the
// stores instead of waiting behind each one.
struct Col {
  int bias;
  float factor;
};

__device__ __forceinline__ Col col_at(const Params& p, int n) {
  return {p.bias != nullptr ? __ldg(p.bias + n) : 0,
          p.requant ? __ldg(p.factors + n) : 0.f};
}

// K7 and K8 round without a conversion instruction (F2I and FRND run at
// a quarter of the FP32 rate or less on the H100): for |y| <= 2^22, y +
// kRound lies in [2^23, 2^24), where floats are the integers, so the IEEE
// round-to-nearest-even of that add is kRound + rint(y) -- ties to even
// too, as kRound is even -- and its bits are 0x4B400000 + rint(y), the low
// byte rint(y) in two's complement.  Every value rounded here is first
// clamped into [-128, 127], and clamping to integer bounds commutes with
// rint: clip(rint(y), lo, hi) == rint(clip(y, lo, hi)).
constexpr float kRound = 12582912.f;  // 1.5 * 2^23, bits 0x4B400000
constexpr int k127Bits = 0x42FE0000;  // the bits of 127.f

// clip(rint(f32(x) * f), -128, 127) -- requant_i8 without ReLU -- as a
// float (exact: an integer).
__device__ __forceinline__ float requant_f32(int x, float f) {
  const float y = __fmul_rn(__int2float_rn(x), f);
  return __fadd_rn(__fadd_rn(fminf(fmaxf(y, -128.f), 127.f), kRound),
                   -kRound);
}

// bias, ReLU and requant of the int32 sum x at a column.
__device__ __forceinline__ int finish(const Params& p, int x, Col col) {
  x += col.bias;
  if (p.relu) x = max(x, 0);
  if (p.requant) x = requant_i8(x, col.factor);
  return x;
}

// K8's finish in its TMA-store epilogue (stage_pairs): bias, ReLU and
// requant as finish computes them, the int8 result the low byte of the
// bits returned -- one conversion a value (int to float) where requant_i8
// runs three.
__device__ __forceinline__ uint32_t finish_bits(const Params& p, int x,
                                                Col col) {
  x += col.bias;
  if (p.relu) x = max(x, 0);
  const float y = __fmul_rn(__int2float_rn(x), col.factor);
  return __float_as_uint(__fadd_rn(fminf(fmaxf(y, -128.f), 127.f), kRound));
}

// K2: the residual join (epilogue.cuh) of n <= 8 requantized int8 values q
// (lowest byte first) with the residual's bytes at r (8-byte aligned when
// n is 8).
__device__ __forceinline__ uint2 join8(const Params& p, uint2 q,
                                       const int8_t* r, int n) {
  uint32_t rv[2] = {0u, 0u};
  if (n == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(r));
    rv[0] = v.x;
    rv[1] = v.y;
  } else {
    for (int e = 0; e < n; ++e)
      rv[e / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(r[e]))
                   << (8 * (e % 4));
  }
  const uint32_t qv[2] = {q.x, q.y};
  uint32_t o[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = residual_join(static_cast<int8_t>(qv[i] >> (8 * b)),
                                  static_cast<int8_t>(rv[i] >> (8 * b)),
                                  p.s_main, p.s_res, p.s_out);
      o[i] |= (static_cast<uint32_t>(j) & 0xffu) << (8 * b);
    }
  return make_uint2(o[0], o[1]);
}

// x[i] for a lane-dependent i, kept in registers.
__device__ __forceinline__ uint32_t pick4(const uint32_t (&x)[4], int i) {
  return i == 0 ? x[0] : i == 1 ? x[1] : i == 2 ? x[2] : x[3];
}

// int8 epilogue of columns [32t, 32t + 32) of the fragment's rows r0 and
// r0 + 8 (bias, ReLU, requant; each column's bias and factor loaded once
// for both rows), transposed across the quad of lanes that holds them (2
// adjacent columns a lane, three shuffles): q[h] is row r0 + 8h's columns
// [8(4t + lq), +8) as 8 bytes.
template <int BN>
__device__ __forceinline__ void quad_bytes(const Params& p,
                                           const int (&acc)[BN / 2],
                                           const Walk& wk, int t, int lq,
                                           uint2 (&q)[2]) {
  uint32_t x[2][4];  // x[h][g]: this lane's pair of group 4t + g
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const int j = 4 * t + g, c = 8 * j + 2 * lq;
    int v[2][2] = {};
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (c + e < wk.ncols) {
        const Col col = col_at(p, wk.n0 + c + e);
        v[0][e] = finish(p, acc[4 * j + e], col);
        v[1][e] = finish(p, acc[4 * j + 2 + e], col);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      x[h][g] = (v[h][0] & 0xffu) | ((v[h][1] & 0xffu) << 8);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t y[4];  // y[l]: lane l's pair of this lane's group 4t + lq
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const uint32_t v = __shfl_xor_sync(0xffffffffu, pick4(x[h], lq ^ d), d);
#pragma unroll
      for (int l = 0; l < 4; ++l)
        if (l == (lq ^ d)) y[l] = v;
    }
    q[h] = make_uint2(y[0] | (y[1] << 16), y[2] | (y[3] << 16));
  }
}

// Byte (r, c) of the int8 output tile staged for the TMA store (BN 64):
// kBM rows of 64 bytes, as the map's 64-byte swizzle places them.
__device__ __forceinline__ uint32_t out_offset(int r, int c) {
  return r * 64 + (((c >> 4) ^ ((r >> 1) & 3)) << 4) + (c & 15);
}

// The int8 epilogue into shared ``tile`` (out_offset's layout), for the
// TMA store: 8 bytes a lane, a quad's 32 in two 16-byte chunks.  kJoin
// (K2): joined with the residual p.res, where given, at the rows and
// columns the store keeps.
template <int BN, bool kJoin>
__device__ __forceinline__ void stage_fragment(const Params& p,
                                               const int (&acc)[BN / 2],
                                               const Walk& wk, int r0,
                                               int lq, uint8_t* tile) {
#pragma unroll
  for (int t = 0; t < BN / 32; ++t) {
    uint2 q[2];
    quad_bytes<BN>(p, acc, wk, t, lq, q);
    const int c0 = 8 * (4 * t + lq);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if constexpr (kJoin) {
        const int64_t gm = static_cast<int64_t>(wk.m0) + r0 + 8 * h;
        if (p.res != nullptr && gm < p.M && c0 < wk.ncols)
          q[h] = join8(p, q[h], p.res + gm * p.N + wk.n0 + c0, 8);
      }
      *reinterpret_cast<uint2*>(tile + out_offset(r0 + 8 * h, c0)) = q[h];
    }
  }
}

// K8's int8 epilogue into shared ``tile`` (out_offset's layout) for the
// TMA store, in the fragment's own layout: each lane's pair of columns
// (8j + 2lq, +1) of rows r0 and r0 + 8 as one 2-byte store, requantized
// by finish_bits -- no transpose across the quad.  A warp's stores hit 32
// distinct banks: its 8 rows differ in the low bit or in the swizzle.
// Columns past ncols lie past N (the tile is its block's, or the last).
template <int BN>
__device__ __forceinline__ void stage_pairs(const Params& p,
                                            const int (&acc)[BN / 2],
                                            const Walk& wk, int r0, int lq,
                                            uint8_t* tile) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * lq;
    const Col c0 = c < wk.ncols ? col_at(p, wk.n0 + c) : Col{};
    const Col c1 = c + 1 < wk.ncols ? col_at(p, wk.n0 + c + 1) : Col{};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t lo = finish_bits(p, acc[4 * j + 2 * h], c0);
      const uint32_t hi = finish_bits(p, acc[4 * j + 2 * h + 1], c1);
      *reinterpret_cast<uint16_t*>(tile + out_offset(r0 + 8 * h, c)) =
          static_cast<uint16_t>(__byte_perm(lo, hi, 0x0040u));
    }
  }
}

// The epilogue of a whole sum straight from the accumulator fragment to
// global memory (split 1, where the TMA store does not take the output).
// int8 out, N % 8 == 0: quad_bytes, so that each lane stores 8 bytes and
// the quad 32 contiguous ones, a whole sector.  Otherwise each lane stores
// its pair, as one 2-byte (int8) or 8-byte (int32: the quad's 32 bytes
// again) store where N is even, else byte by byte.
template <int BN, bool kJoin>
__device__ __forceinline__ void store_fragment(const Params& p,
                                               const int (&acc)[BN / 2],
                                               const Walk& wk, int r0,
                                               int lq) {
  const int64_t gm0 = static_cast<int64_t>(wk.m0) + r0;
  if (p.requant && p.N % 8 == 0) {
#pragma unroll
    for (int t = 0; t < BN / 32; ++t) {
      uint2 q[2];
      quad_bytes<BN>(p, acc, wk, t, lq, q);
      const int c0 = 8 * (4 * t + lq);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t gm = gm0 + 8 * h;
        if (gm >= p.M || c0 >= wk.ncols) continue;
        int8_t* out = static_cast<int8_t*>(p.out) + gm * p.N + wk.n0 + c0;
        if (kJoin && p.res != nullptr)
          q[h] = join8(p, q[h], p.res + gm * p.N + wk.n0 + c0,
                       min(8, wk.ncols - c0));
        if (c0 + 8 <= wk.ncols) {
          *reinterpret_cast<uint2*>(out) = q[h];
        } else {
          for (int e = 0; e < wk.ncols - c0; ++e)
            out[e] = static_cast<int8_t>((e < 4 ? q[h].x : q[h].y) >>
                                         (8 * (e % 4)));
        }
      }
    }
    return;
  }
  const bool pairs = p.N % 2 == 0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * lq;
    if (c >= wk.ncols) continue;
    const int n = wk.n0 + c;
    const bool two = c + 1 < wk.ncols;
    const Col col0 = col_at(p, n), col1 = two ? col_at(p, n + 1) : Col{};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t gm = gm0 + 8 * h;
      if (gm >= p.M) continue;
      int x0 = finish(p, acc[4 * j + 2 * h], col0);
      int x1 = two ? finish(p, acc[4 * j + 2 * h + 1], col1) : 0;
      const int64_t o = gm * p.N + n;
      if (kJoin && p.res != nullptr) {
        x0 = residual_join(x0, p.res[o], p.s_main, p.s_res, p.s_out);
        if (two)
          x1 = residual_join(x1, p.res[o + 1], p.s_main, p.s_res, p.s_out);
      }
      if (p.requant) {
        int8_t* out = static_cast<int8_t*>(p.out) + o;
        if (two && pairs) {
          *reinterpret_cast<uint16_t*>(out) = static_cast<uint16_t>(
              (x0 & 0xff) | ((x1 & 0xff) << 8));
        } else {
          out[0] = static_cast<int8_t>(x0);
          if (two) out[1] = static_cast<int8_t>(x1);
        }
      } else {
        int32_t* out = static_cast<int32_t*>(p.out) + o;
        if (two && pairs) {
          *reinterpret_cast<int2*>(out) = make_int2(x0, x1);
        } else {
          out[0] = x0;
          if (two) out[1] = x1;
        }
      }
    }
  }
}

// ---- K7's epilogue ----------------------------------------------------

// The join of requantized z with residual r (exact floats) --
// epilogue.cuh's residual_join, ReLU included:
// max(clip(rint((z*s_main + r*s_res) / s_out), -128, 127), 0), each float
// step one IEEE f32 operation -- as the bits of kRound + out (low byte
// out); kExpandInv multiplies by p.inv_out in place of the divide.  The
// clamp to [0, 127] runs on the bits as integers: for t >= +0 they order
// as the values do, and every t < 0 (-0 too) has a negative pattern.
template <int kExpand>
__device__ __forceinline__ uint32_t join_bits(const Params& p, float z,
                                              float r) {
  const float s = __fadd_rn(__fmul_rn(z, p.s_main), __fmul_rn(r, p.s_res));
  const float t = kExpand == kExpandInv ? __fmul_rn(s, p.inv_out)
                                        : __fdiv_rn(s, p.s_out);
  const int q = min(max(__float_as_int(t), 0), k127Bits);
  return __float_as_uint(__fadd_rn(__int_as_float(q), kRound));
}

// K7's accumulator starts at the bias: each lane's columns (8j + 2lq, +1)
// of both its rows (acc = bias + sum in int32, the golden's wrap too).
template <int BN>
__device__ __forceinline__ void bias_acc(const Params& p, const Walk& wk,
                                         int lq, int (&acc)[BN / 2]) {
  const int2* bias = reinterpret_cast<const int2*>(p.bias + wk.n0) + lq;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int2 b = 8 * j < wk.ncols ? __ldg(bias + 4 * j) : make_int2(0, 0);
    acc[4 * j] = acc[4 * j + 2] = b.x;
    acc[4 * j + 1] = acc[4 * j + 3] = b.y;
  }
}

// K7's epilogue, in the accumulator fragment's layout: each lane's pair of
// columns (8j + 2lq, +1) of rows r0 and r0 + 8 -- requant without ReLU
// (the bias is in acc already), then the join with the residual pair read
// from ``tile`` (two bytes), written back over it.  ``tile`` holds the
// residual as its map and the output's place it (one box of 128 bytes by
// kBM rows, 128-byte swizzle): each row's 16-byte chunks XORed with the
// row's low 3 bits, which rows r0 and r0 + 8 share.  The next pair's
// factors load while this pair joins.  N % 16 == 0, so a tile's columns
// end on a 16-column boundary (rows past M are the TMA's zeros, and are
// not stored).
template <int BN, int kExpand>
__device__ __forceinline__ void join_tile(const Params& p,
                                          const int (&acc)[BN / 2],
                                          const Walk& wk, int r0, int lq,
                                          uint8_t* tile) {
  uint8_t* row = tile + r0 * 128 + 2 * lq;
  const int sw = r0 & 7;
  const float2* fac = reinterpret_cast<const float2*>(p.factors + wk.n0) + lq;
  float2 f = __ldg(fac);  // columns 8j + 2lq, +1
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    if (8 * j >= wk.ncols) break;
    const float2 fj = f;
    if (j + 1 < BN / 8 && 8 * (j + 1) < wk.ncols) f = __ldg(fac + 4 * (j + 1));
    uint8_t* at = row + (((j >> 1) ^ sw) << 4) + 8 * (j & 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint16_t* pair = reinterpret_cast<uint16_t*>(at + 1024 * h);
      const uint32_t rv = *pair;
      const uint32_t q0 = join_bits<kExpand>(
          p, requant_f32(acc[4 * j + 2 * h], fj.x),
          __int2float_rn(static_cast<int8_t>(rv)));
      const uint32_t q1 = join_bits<kExpand>(
          p, requant_f32(acc[4 * j + 2 * h + 1], fj.y),
          __int2float_rn(static_cast<int8_t>(rv >> 8)));
      *pair = static_cast<uint16_t>(__byte_perm(q0, q1, 0x0040u));
    }
  }
}

// K7's shared memory beside the ring (Cfg<BN, kExpand>::kSmem): after the
// ring's barriers at ``full``, the two residual tiles' barriers; from the
// next 1024 bytes the two tiles, kRes bytes each.
template <typename C>
__device__ __forceinline__ uint32_t res_bar(uint32_t full, int b) {
  return full + 16 * C::kStages + 8 * b;
}

template <typename C>
__device__ __forceinline__ uint32_t res_tile(uint32_t full, int b) {
  return full + 1024 + b * C::kRes;
}

// K7: tile t's residual (one box of 128 bytes by kBM rows) into tile
// buffer b, its bytes reported to that buffer's barrier.
template <int BN, typename C>
__device__ __forceinline__ void load_res(const Params& p,
                                         const CUtensorMap* map, int t,
                                         uint32_t full, int b) {
  const Walk wk = walk_of<BN, false>(p, t, 0);
  mbar_expect_tx(res_bar<C>(full, b), C::kRes);
  tma_load(res_tile<C>(full, b), map, wk.n0, wk.m0, res_bar<C>(full, b));
}

// Grid: with split 1, persistent: CTA b walks tiles b, b + gridDim.x, ...
// (tile t: N tile -- K4's block row, K8's part of one -- t % n_tiles, M
// tile t / n_tiles), the producer running ahead into the next tile while
// the consumers store this one.  With split > 1: one tile a cluster of
// ``split`` CTAs along x.
// kConv (K2, K8, kTma, split 1 only): A is the conv window of x, through
// map_a's im2col mode -- a K byte ax is tap ax / C, channel ax % C, also
// where kBsr (K8) makes it a stored block's column -- and the epilogue
// joins the residual where p.res is given.  kExpand (K7, BN 128, kTma,
// split 1 only): the accumulator starts at the bias; each tile's residual
// arrives through map_res (one box of 128 bytes by kBM rows) in one of
// two tile buffers beside the ring -- consumer thread 0 loads the next
// tile's as this tile's epilogue starts -- is joined in place (join_tile)
// and leaves through map_out (p.tma_out).
template <int BN, bool kBsr, bool kTma, bool kConv = false,
          int kExpand = kNoExpand>
__global__ void __launch_bounds__(kThreads, Cfg<BN>::kMinBlocks)
    gemm_s8_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_w,
                   const __grid_constant__ CUtensorMap map_out,
                   const Params p,
                   const __grid_constant__ CUtensorMap map_res) {
  using C = Cfg<BN, kExpand>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle atoms' grid
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t ring_a = base, ring_w = base + C::kStages * C::kA;
  const uint32_t full = base + C::kRing, empty = full + 8 * C::kStages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rank = blockIdx.x % p.split;
  const int tiles = p.n_tiles * p.m_tiles;
  const int tile0 = blockIdx.x / p.split, tile_step = gridDim.x / p.split;

  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full + 8 * s, kTma ? 1 : 32);
      mbar_init(empty + 8 * s, kConsumers / 32);  // a consumer warp each
    }
    if constexpr (kExpand != kNoExpand) {
      mbar_init(res_bar<C>(full, 0), 1);
      mbar_init(res_bar<C>(full, 1), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // ---- the producer warp ----
    if (kTma && lane != 0) {
    } else {
      int stage = 0, phase = 0;
      for (int tile = tile0; tile < tiles; tile += tile_step) {
        const Walk wk = walk_of<BN, kBsr, kBsr && kConv>(p, tile, rank);
        Pixel px{};  // K2: where the tile's first window starts
        if constexpr (kConv) px = pixel_of(p, wk.m0);
        for (int s = 0; s < wk.nsteps; ++s) {
          int ax, wx, wy;  // A's K byte; W's K byte and row
          if constexpr (kBsr) {
            const int blk = wk.blk0 + wk.first + s / wk.sub;
            wx = (s % wk.sub) * p.bk;
            ax = p.col_idx[blk] * p.bw + wx;
            wy = blk * p.bh;
            if constexpr (kConv) wy += wk.n0 % p.bh;  // K8: the tile's rows
          } else {
            ax = wx = (wk.first + s) * p.bk;
            wy = wk.n0;
          }
          mbar_wait(empty + 8 * stage, phase ^ 1);
          if constexpr (kTma) {
            mbar_expect_tx(full + 8 * stage, (kBM + BN) * p.bk);
            if constexpr (kConv) {
              // K byte ax: tap ax / C at (kh, kw), channels from ax % C
              const int tap = ax / p.C;
              tma_load_im2col(ring_a + stage * C::kA, &map_a, ax - tap * p.C,
                              px.w, px.h, px.n, tap % p.KS, tap / p.KS,
                              full + 8 * stage);
            } else {
              tma_load(ring_a + stage * C::kA, &map_a, ax, wk.m0,
                       full + 8 * stage);
            }
            tma_load(ring_w + stage * C::kW, &map_w, wx, wy,
                     full + 8 * stage);
          } else {
            // 16-byte chunks of the A rows, then the W rows, placed as
            // TMA's 128-byte swizzle places them (bk is 128 here).
            for (int c = lane; c < (kBM + BN) * 8; c += 32) {
              const int r = c / 8, q = c % 8;
              const bool is_a = r < kBM;
              const int row = is_a ? r : r - kBM;
              const int grow = is_a ? wk.m0 + row : wy + row;
              int4 v = make_int4(0, 0, 0, 0);
              if (grow < (is_a ? p.M : p.N))
                v = load_row16((is_a ? p.a : p.w) +
                                   static_cast<int64_t>(grow) * p.K,
                               ax + 16 * q, p.K);
              const int off = is_a ? stage * C::kA
                                   : C::kStages * C::kA + stage * C::kW;
              *reinterpret_cast<int4*>(smem + off + row * kBK +
                                       ((q ^ (row & 7)) << 4)) = v;
            }
            // the generic-proxy stores, visible to wgmma's async proxy
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            mbar_arrive(full + 8 * stage);
          }
          if (++stage == C::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- the consumer warpgroups ----
    const int wg = warp / 4;  // rows [64 * wg, 64 * wg + 64) of the tile
    const int r0 = wg * 64 + (warp % 4) * 16 + lane / 4, lq = lane % 4;
    const int nk = p.bk / 32;
    int stage = 0, phase = 0;
    if constexpr (kExpand != kNoExpand)  // K7: the first tile's residual
      if (tid == 0 && tile0 < tiles)
        load_res<BN, C>(p, &map_res, tile0, full, 0);
    for (int tile = tile0; tile < tiles; tile += tile_step) {
      const Walk wk = walk_of<BN, kBsr, kBsr && kConv>(p, tile, rank);
      int acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      if constexpr (kExpand != kNoExpand) bias_acc<BN>(p, wk, lq, acc);
      int prev = 0;
      for (int s = 0; s < wk.nsteps; ++s) {
        mbar_wait(full + 8 * stage, phase);
        const uint32_t a = ring_a + stage * C::kA + wg * 64 * p.bk;
        const uint32_t w = ring_w + stage * C::kW;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk)
          if (kk < nk)
            wgmma<BN>(acc, smem_desc(a + 32 * kk, p.bk, p.layout),
                      smem_desc(w + 32 * kk, p.bk, p.layout));
        wgmma_commit();
        fence_acc(acc);
        wgmma_wait<1>();  // the previous step's group has retired:
        if (s > 0 && lane == 0) mbar_arrive(empty + 8 * prev);  // free it
        prev = stage;
        if (++stage == C::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      // The TMA store stages the int8 tile over the W half of the tile's
      // last stage (BN x 128 bytes, the tile's size), freed once read.
      const bool via_tma =
          C::kTmaOut && p.tma_out && p.split == 1 && wk.nsteps > 0;
      if (wk.nsteps > 0 && !via_tma && lane == 0)
        mbar_arrive(empty + 8 * prev);
      if constexpr (kExpand != kNoExpand) {
        // K7: the next tile's residual goes into the other buffer once the
        // store that last read it has read it.
        const int joined = (tile - tile0) / tile_step;  // tiles before
        const int buf = joined & 1;
        if (tid == 0) {
          bulk_wait_read();
          if (tile + tile_step < tiles)
            load_res<BN, C>(p, &map_res, tile + tile_step, full, buf ^ 1);
        }
        mbar_wait(res_bar<C>(full, buf), (joined >> 1) & 1);
        join_tile<BN, kExpand>(p, acc, wk, r0, lq,
                               smem + (res_tile<C>(full, buf) - base));
        // the generic-proxy stores, visible to the TMA's async proxy
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
        if (tid == 0) {
          tma_store(&map_out, wk.n0, wk.m0, res_tile<C>(full, buf));
          bulk_commit();
        }
        continue;
      }
      if (via_tma) {
        if constexpr (C::kTmaOut) {
          // both warpgroups' wgmmas have read the stage's W
          asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
          const uint32_t tile = ring_w + prev * C::kW;
          if constexpr (kBsr && kConv)
            stage_pairs<BN>(p, acc, wk, r0, lq, smem + (tile - base));
          else
            stage_fragment<BN, kConv>(p, acc, wk, r0, lq,
                                      smem + (tile - base));
          // the generic-proxy stores, visible to the TMA's async proxy
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
          if (tid == 0) {
            tma_store(&map_out, wk.n0, wk.m0, tile);
            bulk_commit();
            bulk_wait_read();
            mbar_arrive_n(empty + 8 * prev, kConsumers / 32);
          }
        }
      } else if (p.split == 1) {
        store_fragment<BN, kConv>(p, acc, wk, r0, lq);
      } else {
        // Both warpgroups are done with the ring (this cluster's only
        // tile): stage the partial over it.
        asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        int* st = reinterpret_cast<int*>(smem);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int c = 8 * j + 2 * lq;
          *reinterpret_cast<int2*>(&st[r0 * C::kLd + c]) =
              make_int2(acc[4 * j], acc[4 * j + 1]);
          *reinterpret_cast<int2*>(&st[(r0 + 8) * C::kLd + c]) =
              make_int2(acc[4 * j + 2], acc[4 * j + 3]);
        }
      }
    }
  }
  if (p.split == 1) {
    if (p.tma_out && tid == 0) bulk_wait();  // the last tile's stores
    return;
  }

  cluster_sync();  // every rank's partial is staged

  // This rank's rows, 16 columns a unit: the partials of every rank added,
  // then the epilogue, then the stores.
  if (tid < kConsumers) {
    const Walk wk = walk_of<BN, kBsr, kBsr && kConv>(p, tile0, rank);
    const int* st = reinterpret_cast<const int*>(smem);
    const int rows = kBM / p.split, per_row = BN / 16;
    const int esize = p.requant ? 1 : 4;
    for (int u = tid; u < rows * per_row; u += kConsumers) {
      const int row = rank * rows + u / per_row, c = (u % per_row) * 16;
      const int64_t gm = static_cast<int64_t>(wk.m0) + row;
      if (gm >= p.M || c >= wk.ncols) continue;
      int v[16];
      const int at = row * C::kLd + c;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        put4(v, g, *reinterpret_cast<const int4*>(&st[at + 4 * g]), false);
      for (int q = 0; q < p.split; ++q) {
        if (q == rank) continue;
#pragma unroll
        for (int g = 0; g < 4; ++g)
          put4(v, g, ld_cluster(base + 4 * (at + 4 * g), q), true);
      }
      uint32_t w[16] = {};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int x =
            c + j < wk.ncols ? finish(p, v[j], col_at(p, wk.n0 + c + j)) : 0;
        if (p.requant)
          w[j / 4] |= (static_cast<uint32_t>(x) & 0xffu) << (8 * (j % 4));
        else
          w[j] = static_cast<uint32_t>(x);
      }
      const int valid = (wk.ncols - c < 16 ? wk.ncols - c : 16) * esize;
      store_unit(static_cast<uint8_t*>(p.out) +
                     (gm * p.N + wk.n0 + c) * esize,
                 w, 16 * esize, valid, p.vec);
    }
  }

  cluster_sync();  // no CTA leaves while another reads its partial
}

// ---- the host side --------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

using EncodeIm2col = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const int*, const int*,
                                  cuuint32_t, cuuint32_t, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// A CUDA entry point fetched at run time through the runtime API, so that
// the library needs no -lcuda; null where the installed CUDA lacks it.
void* entry_point(const char* name) {
  void* f = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  const cudaError_t err =
      cudaGetDriverEntryPointByVersion(name, &f, 12000, cudaEnableDefault, &q);
#else
  const cudaError_t err =
      cudaGetDriverEntryPoint(name, &f, cudaEnableDefault, &q);
#endif
  return err == cudaSuccess && q == cudaDriverEntryPointSuccess ? f : nullptr;
}

EncodeTiled encode_tiled() {
  static const EncodeTiled fn =
      reinterpret_cast<EncodeTiled>(entry_point("cuTensorMapEncodeTiled"));
  return fn;
}

EncodeIm2col encode_im2col() {
  static const EncodeIm2col fn =
      reinterpret_cast<EncodeIm2col>(entry_point("cuTensorMapEncodeIm2col"));
  return fn;
}

// The wgmma swizzle code of a bk-byte K box (the tensor map's swizzle).
int layout_of(int bk) { return bk == 128 ? 1 : bk == 64 ? 2 : 3; }

// A map over the int8 array [rows, inner] of row pitch ``inner`` bytes,
// boxes of box_inner bytes by box_rows rows, swizzled by box_inner bytes.
// ``wide``: L2 fetches each row's 256 bytes around the box, for boxes
// whose neighbours are read next (dense walks); else only the box's own
// bytes (K4's A: the next box of a row is often a block column no block
// row stores).
cudaError_t make_map(CUtensorMap* map, const void* ptr, int64_t inner,
                     int64_t rows, int box_inner, int box_rows, bool wide) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapSwizzle swizzle =
      box_inner == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : box_inner == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUtensorMapL2promotion promotion =
      wide               ? CU_TENSOR_MAP_L2_PROMOTION_L2_256B
      : box_inner >= 128 ? CU_TENSOR_MAP_L2_PROMOTION_L2_128B
      : box_inner == 64  ? CU_TENSOR_MAP_L2_PROMOTION_L2_64B
                         : CU_TENSOR_MAP_L2_PROMOTION_NONE;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, promotion,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// K2's A map: x [N, H, W, C] int8 channels-last in im2col mode, boxes of
// 128 output pixels by bk channels (swizzled by bk bytes).  The pixel box
// is the positions of the windows' top-left taps: from (-pad_w, -pad_h)
// to the last output's ((Wo - 1) * stride - pad_w, ...), which the upper
// corner gives relative to the tensor's far edge; TMA steps through it at
// the conv's stride and zero-fills every tap that falls outside x.
cudaError_t make_im2col_map(CUtensorMap* map, const Params& p) {
  const EncodeIm2col fn = encode_im2col();
  if (fn == nullptr) return cudaErrorNotSupported;
  const int N = p.M / (p.Ho * p.Wo);
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(p.C), static_cast<cuuint64_t>(p.W),
      static_cast<cuuint64_t>(p.H), static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(p.C),
      static_cast<cuuint64_t>(p.C) * p.W,
      static_cast<cuuint64_t>(p.C) * p.W * p.H};
  const int lower[2] = {-p.pad_w, -p.pad_h};
  const int upper[2] = {-p.pad_w + (p.Wo - 1) * p.stride - (p.W - 1),
                        -p.pad_h + (p.Ho - 1) * p.stride - (p.H - 1)};
  const cuuint32_t elem[4] = {1, static_cast<cuuint32_t>(p.stride),
                              static_cast<cuuint32_t>(p.stride), 1};
  const CUtensorMapSwizzle swizzle =
      p.bk == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : p.bk == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                   : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<int8_t*>(p.a), dims,
      strides, lower, upper, static_cast<cuuint32_t>(p.bk), kBM, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The TMA store's map over the int8 output [M, N] (boxes of 64 bytes by
// kBM rows), where it takes it: Cfg<BN>::kTmaOut, split 1, N % 16 == 0
// (16-byte row pitch), a 16-byte aligned base and tiles that do not reach
// into their neighbours' columns (``whole``).  p.tma_out says whether it
// does.
template <int BN>
cudaError_t make_out_map(CUtensorMap* map, Params& p, bool whole) {
  p.tma_out = Cfg<BN>::kTmaOut && p.requant && p.split == 1 && whole &&
              p.N % 16 == 0 && reinterpret_cast<uintptr_t>(p.out) % 16 == 0;
  if (!p.tma_out) return cudaSuccess;
  return make_map(map, p.out, p.N, p.M, 64, kBM, true);
}

// The widest store (16 bytes down to 1) that every output row of ``pitch``
// bytes, every tile start ``step`` bytes apart and the base allow.
int store_width(int64_t pitch, int64_t step, const void* out) {
  int v = 16;
  while (v > 1 && (pitch % v || step % v ||
                   reinterpret_cast<uintptr_t>(out) % v))
    v /= 2;
  return v;
}

// One launch: with split 1, as many CTAs as the card holds at once (at
// most one a tile), each walking tiles; else a cluster of ``split`` CTAs a
// tile.  A cluster of one is launched without the cluster attribute: on
// the H100 that launch is 1-2 us faster.
template <int BN, bool kBsr, bool kTma, bool kConv = false,
          int kExpand = kNoExpand>
cudaError_t launch(const CUtensorMap& map_a, const CUtensorMap& map_w,
                   const CUtensorMap& map_out, const Params& p,
                   cudaStream_t stream,
                   const CUtensorMap& map_res = CUtensorMap{}) {
  using C = Cfg<BN, kExpand>;
  auto* kernel = gemm_s8_kernel<BN, kBsr, kTma, kConv, kExpand>;
  // resident CTAs on the device, found once per device and instantiation
  static int resident[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kThreads, C::kSmem);
    if (err != cudaSuccess) return err;
    if (per_sm == 0) return cudaErrorInvalidConfiguration;
    resident[dev] = per_sm * sms;
  }
  const int64_t tiles = static_cast<int64_t>(p.n_tiles) * p.m_tiles;
  const int64_t ctas = p.split == 1
                           ? (tiles < resident[dev] ? tiles : resident[dev])
                           : tiles * p.split;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(ctas), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = C::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(p.split);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.split > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, map_a, map_w, map_out, p, map_res);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace
}  // namespace sm90
