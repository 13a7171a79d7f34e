// Exact int8 tensor-core products on Hopper (sm_90a) with mma.sync, shared by
// K1 (fused_eval.cu) and the probes P2 and P3 (probes.cu): one fragment
// layout, one digit split (P3 splits its 16-bit operands in base 256
// instead, a u8 low digit and an s8 top digit: see probes.cu).
//
// D = A * B + D on one warp: A 16x16 s8 (row), B 16x8 s8 (col), D 16x8 s32.
// Fragments (PTX ISA, mma.m16n8k16 with .s8 operands), g = lane >> 2,
// t = lane & 3, four bytes packed in a register with the lowest k lowest:
//   a[0] = A[g][4t .. 4t+3]        a[1] = A[g+8][4t .. 4t+3]
//   b    = B[4t .. 4t+3][g]        (= row g of B^T, four bytes)
//   d[0], d[1] = D[g][2t], D[g][2t+1]    d[2], d[3] = D[g+8][2t], D[g+8][2t+1]
// So A is read as rows of a row-major tile and B as rows of B^T (K-major):
// both fragments are 4-byte loads of 4 consecutive k. No .satfinite: every
// sum these kernels form stays inside int32 (each states its bound).
//
// Base-128 digits. A wide integer operand v is split into NDIG digits,
//   v = sum_k d_k * 128^k,  d_k = (v >> 7k) & 127 (k < NDIG-1, unsigned
//   0..127),  d_top = v >> 7(NDIG-1) (signed, arithmetic shift),
// each of which fits s8 when |v| < 2^(7 NDIG - 1). The product is
// recombined by Horner's rule in the int32 accumulator, top digit first:
//   acc = d_top @ B;  acc = acc * 128 + d_k @ B  for k = NDIG-2 .. 0,
// so after each step acc = (v >> 7k) @ B exactly: every partial is the
// product of a right-shifted operand and stays inside the final sum's bound.

#pragma once

#include <cstdint>

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[2],
                                       uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// the same with A unsigned (u8 x s8 -> s32): A's bytes are 0..255
__device__ __forceinline__ void mma_u8s8(int (&d)[4], const uint32_t (&a)[2],
                                         uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.u8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

__device__ __forceinline__ uint32_t ld_u32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// digit k of v as a byte: low digits unsigned (0..127), the top one signed
template <bool TOP>
__device__ __forceinline__ int8_t digit(int v, int k) {
  const int d = v >> (7 * k);
  return static_cast<int8_t>(TOP ? d : d & 127);
}
