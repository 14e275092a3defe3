// float32-accurate products on Hopper's tensor cores: 3xTF32 mma.sync.
//
// A TF32 operand keeps 10 explicit mantissa bits, so one TF32 product
// of float32 inputs is good to about 3 decimal digits.  The split
// x = big + small, with big = tf32(x) and small = tf32(x - big), keeps
// about 22 bits, and
//
//   a.b ~ big_a.big_b + big_a.small_b + small_a.big_b
//
// drops only small_a.small_b (below 2^-22 of |a||b|): three MMAs per
// product, each product of two TF32 values exact in the float32
// accumulator.  The small terms go in first so that they are not lost
// against the large partial sum.
//
// One warp computes D = A B + C on a 16x8x8 tile with
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 (PTX ISA, "Matrix
// Fragments for mma.m16n8k8", .tf32; CUTLASS's arch/mma_sm80.h wraps the
// same instruction).  With g = lane / 4 and t = lane % 4, lane holds
//   A (16x8, row major): a0 = A[g][t],  a1 = A[g+8][t],
//                        a2 = A[g][t+4], a3 = A[g+8][t+4];
//   B (8x8, column major): b0 = B[t][g], b1 = B[t+4][g];
//   C, D (16x8):  c0 = C[g][2t], c1 = C[g][2t+1],
//                 c2 = C[g+8][2t], c3 = C[g+8][2t+1].
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// The rounding of cvt.rna.tf32.f32: to nearest, ties away from zero, to
// 10 explicit mantissa bits, as a float32 bit pattern whose low 13 bits
// are zero.  Adding half of the dropped bits to the magnitude and
// clearing them is that rounding for every finite x (a carry into the
// exponent is the round-up it should be), in two integer operations;
// the PTX conversion gives the same bits and was measurably slower in
// both kernels on an H100.
static __device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small to about 22 significant bits.
static __device__ __forceinline__ void tf32_split(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// A fragment of one 16x8 operand, split.
struct FragA {
  uint32_t big[4], small[4];
};
// A fragment of one 8x8 operand, split.
struct FragB {
  uint32_t big[2], small[2];
};

static __device__ __forceinline__ void frag_a(FragA& f, float a0, float a1, float a2, float a3) {
  tf32_split(a0, f.big[0], f.small[0]);
  tf32_split(a1, f.big[1], f.small[1]);
  tf32_split(a2, f.big[2], f.small[2]);
  tf32_split(a3, f.big[3], f.small[3]);
}

static __device__ __forceinline__ void frag_b(FragB& f, float b0, float b1) {
  tf32_split(b0, f.big[0], f.small[0]);
  tf32_split(b1, f.big[1], f.small[1]);
}

// d = a b + d, one m16n8k8 TF32 MMA with a float32 accumulator.  Not
// volatile: the compiler may interleave independent MMAs.
static __device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                                const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[j] += a b[j] to float32 accuracy for N column tiles: the three
// products of the split into one accumulator per tile, issued product by
// product across the tiles, so that consecutive MMAs write different
// accumulators and no MMA waits on the one before it.
template <int N>
static __device__ __forceinline__ void mma3(float (*d)[4], const FragA& a, const FragB* b) {
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(d[j], a.small, b[j].big);
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(d[j], a.big, b[j].small);
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(d[j], a.big, b[j].big);
}
