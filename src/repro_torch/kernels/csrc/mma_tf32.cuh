// Warp-level float32 matrix products on Hopper's tensor cores, as 3xTF32.
//
// One TF32 pass keeps 10 mantissa bits of each operand, about 3 decimal
// digits: the SSD chunk scan would miss its 1e-4 tolerance by an order of
// magnitude. 3xTF32 splits each fp32 operand x into big = tf32(x) and
// small = tf32(x − big) and sums small·big + big·small + big·big (CUTLASS's
// OpMultiplyAddFastF32 order; small·small, below fp32's rounding, is left
// out), which keeps about fp32's accuracy at three tensor-core products.
//
// The product is mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32. With
// g = lane >> 2 and t = lane & 3, its fragments (PTX ISA) are
//   A (16 × 8):  a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B (8 × 8):   b0 (k t, n g), b1 (k t+4, n g)
//   C (16 × 8):  c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
// warp_tile_mma_3xtf32 covers an (MT·16) × (NT·8) tile of the warp over K in
// steps of 8, reading both operands from shared memory through element
// strides, so a transposed operand is only other strides.
#pragma once

#include <cstdint>

namespace {

// tf32(x), rounded to nearest with ties away from zero, as an fp32 bit
// pattern whose low 13 bits are cleared.
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_bits(x);
  small = tf32_bits(__fsub_rn(x, __uint_as_float(big)));  // exact in fp32
}

// d += a·b on one m16n8k8 tile.
__device__ __forceinline__ void mma_m16n8k8_tf32(float (&d)[4], const uint32_t (&a)[4],
                                                 const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[mt][nt] += A·B over k (a multiple of 8) for the warp's tile: rows
// mt·16 + (0..15) of A, columns nt·8 + (0..7) of B. A(i, kk) is
// A[i·a_row + kk·a_col] and B(kk, j) is B[kk·b_k + j·b_n], both in shared
// memory. acc[mt][nt][r] holds the C fragment element r of tile (mt, nt).
template <int MT, int NT>
__device__ __forceinline__ void warp_tile_mma_3xtf32(float (&acc)[MT][NT][4],
                                                     const float* A, int a_row, int a_col,
                                                     const float* B, int b_k, int b_n, int k) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int k0 = 0; k0 < k; k0 += 8) {
    uint32_t a_big[MT][4], a_small[MT][4], b_big[NT][2], b_small[NT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float* a = A + (mt * 16 + g) * a_row + (k0 + t) * a_col;
      split_tf32(a[0], a_big[mt][0], a_small[mt][0]);
      split_tf32(a[8 * a_row], a_big[mt][1], a_small[mt][1]);
      split_tf32(a[4 * a_col], a_big[mt][2], a_small[mt][2]);
      split_tf32(a[8 * a_row + 4 * a_col], a_big[mt][3], a_small[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* b = B + (k0 + t) * b_k + (nt * 8 + g) * b_n;
      split_tf32(b[0], b_big[nt][0], b_small[nt][0]);
      split_tf32(b[4 * b_k], b_big[nt][1], b_small[nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma_m16n8k8_tf32(acc[mt][nt], a_small[mt], b_big[nt]);
        mma_m16n8k8_tf32(acc[mt][nt], a_big[mt], b_small[nt]);
        mma_m16n8k8_tf32(acc[mt][nt], a_big[mt], b_big[nt]);
      }
    }
  }
}

// Row and column, within the warp's tile, of accumulator element r of tile
// (mt, nt).
__device__ __forceinline__ int acc_row(int mt, int r) {
  return mt * 16 + ((threadIdx.x & 31) >> 2) + ((r & 2) ? 8 : 0);
}
__device__ __forceinline__ int acc_col(int nt, int r) {
  return nt * 8 + 2 * (threadIdx.x & 3) + (r & 1);
}

}  // namespace
