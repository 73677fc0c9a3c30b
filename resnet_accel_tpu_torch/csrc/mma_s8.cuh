// The int8 tensor-core step shared by K2 and K4: one warp-wide
// mma.sync m16n8k32, int8 x int8 -> int32, accumulating in place.
//
// Fragments (PTX ISA, "mma.m16n8k32" for .s8): with g = lane / 4 and
// t = lane % 4, A's four words hold rows (g, g + 8) x K words (t, t + 4)
// of a row-major 16 x 32 tile; B's two words hold column g x K words
// (t, t + 4) of a 32 x 8 tile stored column by column; C holds rows
// (g, g + 8) x columns (2t, 2t + 1).  A word is four int8 values, the
// lowest K index in the lowest byte.
#pragma once

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4],
                                       int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
