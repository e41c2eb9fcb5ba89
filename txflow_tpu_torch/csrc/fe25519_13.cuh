// GF(2^255-19) in twenty radix-2^13 int32 limbs for one CUDA thread (K8).
//
// Replaces: txflow_tpu/ops/fe13.py (bytes_to_limbs_device, fe_carry,
// fe_add, fe_sub, fe_mul, fe_sq, fe_mul_small, fe_freeze) and, through
// fe_common.cuh, the fe_inv / fe_is_equal_frozen it takes from
// ops/_fe_common.py. verify.cu built with -DTXF_FE_RADIX=13 runs the
// curve and verify code (ge25519.cuh) over this field.
//
// Layout: limb i holds bits [13 i, 13 i + 13); 20 * 13 = 260 bits, and
// 2^260 = 608 (mod p) folds the carry out of limb 19 into limb 0. Every
// function computes exactly what the JAX function of the same name
// computes, limb for limb (the same carry passes in the same order), in
// int32 arithmetic only: no 64-bit product anywhere, where the
// radix-2^25.5 field (fe25519.cuh, K1) multiplies 32x32->64. That is the
// trade this field makes on the card: 400 32-bit multiply-adds a product
// against K1's 100 wide ones, and twice the registers a field element.
//
// What bounds it: integer multiply-adds (427 a product, 256 a squaring,
// see ops/fe13.py:MADS_PER_MUL and MADS_PER_SQ) and registers: a product
// holds its 39 column sums and both inputs (79 registers), a point 80. The
// limb loops are fully unrolled so every array stays in registers as far
// as the 255 a thread allow; the rest spills to local memory (ptxas -v
// says how much). A product is its column sums (fe13_mul_columns, or
// fe13_sq_columns for a squaring: each limb pair once) and one carry
// (fe13_reduce). Built by nvcc 12.9 for sm_90a, one fe_mul is 720 SASS
// instructions (426 IMAD), one fe_sq 529 (236), where fe_sq as fe_mul(f,
// f) took 547: nvcc had already merged most mirrored products f_i f_j, f_j
// f_i of that form. The carry is 2 instructions a limb a pass (LOP3 and
// LEA.HI.SX32), 267 of a product's. Columns summed as two running sums
// joined once (a chain of 10 multiply-adds, not 20) were 3-6% slower on
// the card, so each column is one running sum (probe kernels and kernels
// in turns of txflow_tpu_torch/parent_ab.py --kernels-ab, NVIDIA H100).
//
// Bounds (JAX's, tests/test_torch_fe13.py checks the worst cases): a
// "normalized" element has every limb in [0, 9408]. fe_mul needs
// normalized inputs: a column of 20 products is then < 20 * 9408^2 =
// 1.77e9 < 2^31. The high columns reach about 2^30.7, so they are carried
// 3 passes (to < 2^13.2 a limb) before the x608 fold. fe_add and fe_sub
// return normalized values (1 and 2 carry passes), fe_mul and
// fe_mul_small too (4 passes); table entries are canonical. So every
// value the curve formulas of ge25519.cuh feed to fe_mul is normalized:
// each is a product, a sum, a difference or a table coordinate, never an
// un-carried sum. fe_freeze takes any value whose limbs are in [0, 2^31).
#pragma once
#include <stdint.h>

#ifndef TXF_DEV
#define TXF_DEV __device__ __forceinline__
#endif

#define TXF_NLIMB 20
typedef int32_t fe[TXF_NLIMB];

#define TXF_R13 13
#define TXF_M13 8191
#define TXF_WRAP13 608  // 2^260 mod p

// p's limbs (ops/fe13.py:P_LIMBS) and 128 p, the borrow-free offset of
// fe_sub: 128 * 255 = 32640 dominates any normalized top limb.
#define TXF_P13(i) ((i) == 0 ? 8173 : ((i) == 19 ? 255 : 8191))

// One data-parallel carry pass in place: limb i becomes its low 13 bits
// plus the carry of limb i-1 (limb 0: plus 608 times the carry of limb
// 19). Going down from limb 19 reads each neighbour before it changes.
TXF_DEV void fe13_carry_pass(int32_t* x) {
  const int32_t top = x[19] >> TXF_R13;
#pragma unroll
  for (int i = 19; i > 0; --i) x[i] = (x[i] & TXF_M13) + (x[i - 1] >> TXF_R13);
  x[0] = (x[0] & TXF_M13) + TXF_WRAP13 * top;
}

TXF_DEV void fe13_carry(int32_t* x, int passes) {
#pragma unroll
  for (int k = 0; k < passes; ++k) fe13_carry_pass(x);
}

// h = f + g, carried once (normalized). h may alias f or g.
TXF_DEV void fe_add(fe h, const fe f, const fe g) {
#pragma unroll
  for (int i = 0; i < TXF_NLIMB; ++i) h[i] = f[i] + g[i];
  fe13_carry(h, 1);
}

// h = f - g + 128 p, carried twice (normalized). h may alias f or g.
TXF_DEV void fe_sub(fe h, const fe f, const fe g) {
#pragma unroll
  for (int i = 0; i < TXF_NLIMB; ++i) h[i] = f[i] + 128 * TXF_P13(i) - g[i];
  fe13_carry(h, 2);
}

// The 39 column sums of f * g, c[k] = sum of f_i g_j over i + j = k, for
// normalized f, g: one running sum a column, i outer, j inner.
TXF_DEV void fe13_mul_columns(int32_t c[2 * TXF_NLIMB - 1], const fe f, const fe g) {
#pragma unroll
  for (int k = 0; k < 2 * TXF_NLIMB - 1; ++k) c[k] = 0;
#pragma unroll
  for (int i = 0; i < TXF_NLIMB; ++i) {
#pragma unroll
    for (int j = 0; j < TXF_NLIMB; ++j) c[i + j] += f[i] * g[j];
  }
}

// The 39 column sums of f * f: fe13_mul_columns(c, f, f)'s values term for
// term, with each pair i < j taken once as (2 f_i) f_j (d_i = 2 f_i) and
// each square f_i^2 once: 190 + 20 multiply-adds and 19 doublings where
// the product takes 400. Bounds at the normalized limit of 9408: d_i <=
// 18816, a doubled term <= 2 * 9408^2 = 1.77e8, and every running sum is
// at most its column's total, <= 20 * 9408^2 = 1.770e9 < 2^31 (the same
// column of fe_mul: all terms are non-negative), so no term or sum
// overflows int32.
TXF_DEV void fe13_sq_columns(int32_t c[2 * TXF_NLIMB - 1], const fe f) {
  const int32_t f0 = f[0], f1 = f[1], f2 = f[2], f3 = f[3], f4 = f[4];
  const int32_t f5 = f[5], f6 = f[6], f7 = f[7], f8 = f[8], f9 = f[9];
  const int32_t f10 = f[10], f11 = f[11], f12 = f[12], f13 = f[13], f14 = f[14];
  const int32_t f15 = f[15], f16 = f[16], f17 = f[17], f18 = f[18], f19 = f[19];
  const int32_t d0 = 2 * f0, d1 = 2 * f1, d2 = 2 * f2, d3 = 2 * f3, d4 = 2 * f4;
  const int32_t d5 = 2 * f5, d6 = 2 * f6, d7 = 2 * f7, d8 = 2 * f8, d9 = 2 * f9;
  const int32_t d10 = 2 * f10, d11 = 2 * f11, d12 = 2 * f12, d13 = 2 * f13;
  const int32_t d14 = 2 * f14, d15 = 2 * f15, d16 = 2 * f16, d17 = 2 * f17;
  const int32_t d18 = 2 * f18;
  c[0] = f0 * f0;
  c[1] = d0 * f1;
  c[2] = d0 * f2 + f1 * f1;
  c[3] = d0 * f3 + d1 * f2;
  c[4] = d0 * f4 + d1 * f3 + f2 * f2;
  c[5] = d0 * f5 + d1 * f4 + d2 * f3;
  c[6] = d0 * f6 + d1 * f5 + d2 * f4 + f3 * f3;
  c[7] = d0 * f7 + d1 * f6 + d2 * f5 + d3 * f4;
  c[8] = d0 * f8 + d1 * f7 + d2 * f6 + d3 * f5 + f4 * f4;
  c[9] = d0 * f9 + d1 * f8 + d2 * f7 + d3 * f6 + d4 * f5;
  c[10] = d0 * f10 + d1 * f9 + d2 * f8 + d3 * f7 + d4 * f6 + f5 * f5;
  c[11] = d0 * f11 + d1 * f10 + d2 * f9 + d3 * f8 + d4 * f7 + d5 * f6;
  c[12] = d0 * f12 + d1 * f11 + d2 * f10 + d3 * f9 + d4 * f8 + d5 * f7 + f6 * f6;
  c[13] = d0 * f13 + d1 * f12 + d2 * f11 + d3 * f10 + d4 * f9 + d5 * f8 + d6 * f7;
  c[14] = d0 * f14 + d1 * f13 + d2 * f12 + d3 * f11 + d4 * f10 + d5 * f9 + d6 * f8 + f7 * f7;
  c[15] = d0 * f15 + d1 * f14 + d2 * f13 + d3 * f12 + d4 * f11 + d5 * f10 + d6 * f9 + d7 * f8;
  c[16] = d0 * f16 + d1 * f15 + d2 * f14 + d3 * f13 + d4 * f12 + d5 * f11 + d6 * f10 + d7 * f9 +
          f8 * f8;
  c[17] = d0 * f17 + d1 * f16 + d2 * f15 + d3 * f14 + d4 * f13 + d5 * f12 + d6 * f11 + d7 * f10 +
          d8 * f9;
  c[18] = d0 * f18 + d1 * f17 + d2 * f16 + d3 * f15 + d4 * f14 + d5 * f13 + d6 * f12 + d7 * f11 +
          d8 * f10 + f9 * f9;
  c[19] = d0 * f19 + d1 * f18 + d2 * f17 + d3 * f16 + d4 * f15 + d5 * f14 + d6 * f13 + d7 * f12 +
          d8 * f11 + d9 * f10;
  c[20] = d1 * f19 + d2 * f18 + d3 * f17 + d4 * f16 + d5 * f15 + d6 * f14 + d7 * f13 + d8 * f12 +
          d9 * f11 + f10 * f10;
  c[21] = d2 * f19 + d3 * f18 + d4 * f17 + d5 * f16 + d6 * f15 + d7 * f14 + d8 * f13 + d9 * f12 +
          d10 * f11;
  c[22] = d3 * f19 + d4 * f18 + d5 * f17 + d6 * f16 + d7 * f15 + d8 * f14 + d9 * f13 + d10 * f12 +
          f11 * f11;
  c[23] = d4 * f19 + d5 * f18 + d6 * f17 + d7 * f16 + d8 * f15 + d9 * f14 + d10 * f13 +
          d11 * f12;
  c[24] = d5 * f19 + d6 * f18 + d7 * f17 + d8 * f16 + d9 * f15 + d10 * f14 + d11 * f13 +
          f12 * f12;
  c[25] = d6 * f19 + d7 * f18 + d8 * f17 + d9 * f16 + d10 * f15 + d11 * f14 + d12 * f13;
  c[26] = d7 * f19 + d8 * f18 + d9 * f17 + d10 * f16 + d11 * f15 + d12 * f14 + f13 * f13;
  c[27] = d8 * f19 + d9 * f18 + d10 * f17 + d11 * f16 + d12 * f15 + d13 * f14;
  c[28] = d9 * f19 + d10 * f18 + d11 * f17 + d12 * f16 + d13 * f15 + f14 * f14;
  c[29] = d10 * f19 + d11 * f18 + d12 * f17 + d13 * f16 + d14 * f15;
  c[30] = d11 * f19 + d12 * f18 + d13 * f17 + d14 * f16 + f15 * f15;
  c[31] = d12 * f19 + d13 * f18 + d14 * f17 + d15 * f16;
  c[32] = d13 * f19 + d14 * f18 + d15 * f17 + f16 * f16;
  c[33] = d14 * f19 + d15 * f18 + d16 * f17;
  c[34] = d15 * f19 + d16 * f18 + f17 * f17;
  c[35] = d16 * f19 + d17 * f18;
  c[36] = d17 * f19 + f18 * f18;
  c[37] = d18 * f19;
  c[38] = f19 * f19;
}

// The column sums c[0..38] of a product -> normalized limbs, JAX's steps:
// columns 20..38 (and a zero 40th) carried 3 passes, folded into the low
// 20 times 608 (2^260 mod p), then 4 carry passes. c is overwritten.
TXF_DEV void fe13_reduce(fe h, int32_t c[2 * TXF_NLIMB - 1]) {
  int32_t hi[TXF_NLIMB];
#pragma unroll
  for (int i = 0; i < TXF_NLIMB - 1; ++i) hi[i] = c[TXF_NLIMB + i];
  hi[TXF_NLIMB - 1] = 0;
  fe13_carry(hi, 3);
#pragma unroll
  for (int i = 0; i < TXF_NLIMB; ++i) c[i] += TXF_WRAP13 * hi[i];
  fe13_carry(c, 4);
#pragma unroll
  for (int i = 0; i < TXF_NLIMB; ++i) h[i] = c[i];
}

// h = f * g mod p for normalized f, g. h may alias f or g.
TXF_DEV void fe_mul(fe h, const fe f, const fe g) {
  int32_t c[2 * TXF_NLIMB - 1];
  fe13_mul_columns(c, f, g);
  fe13_reduce(h, c);
}

// h = f^2 mod p for normalized f: fe_mul(h, f, f)'s limbs. h may alias f.
TXF_DEV void fe_sq(fe h, const fe f) {
  int32_t c[2 * TXF_NLIMB - 1];
  fe13_sq_columns(c, f);
  fe13_reduce(h, c);
}

// h = f * c for a small constant c (c * 9408 < 2^31), carried 4 passes.
TXF_DEV void fe_mul_small(fe h, const fe f, int32_t c) {
#pragma unroll
  for (int i = 0; i < TXF_NLIMB; ++i) h[i] = f[i] * c;
  fe13_carry(h, 4);
}

// Exact canonical reduction, JAX's steps: 5 carry passes; twice, fold the
// bits >= 255 of limb 19 into limb 0 times 19 and carry 2 passes; twice,
// subtract p with a borrow chain and keep the difference when it did not
// borrow out; 2 carry passes.
TXF_DEV void fe_freeze(fe out, const fe f) {
  int32_t x[TXF_NLIMB];
#pragma unroll
  for (int i = 0; i < TXF_NLIMB; ++i) x[i] = f[i];
  fe13_carry(x, 5);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int32_t t = x[19] >> 8;
    x[19] &= 0xFF;
    x[0] += 19 * t;
    fe13_carry(x, 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int32_t sub[TXF_NLIMB];
    int32_t borrow = 0;
#pragma unroll
    for (int i = 0; i < TXF_NLIMB; ++i) {
      const int32_t d = x[i] - TXF_P13(i) - borrow;
      borrow = d < 0 ? 1 : 0;
      sub[i] = d + (borrow << TXF_R13);
    }
    if (borrow == 0) {
#pragma unroll
      for (int i = 0; i < TXF_NLIMB; ++i) x[i] = sub[i];
    }
  }
  fe13_carry(x, 2);
#pragma unroll
  for (int i = 0; i < TXF_NLIMB; ++i) out[i] = x[i];
}

// 32 little-endian bytes -> exact limbs of all 256 bits (JAX's 13-bit
// repack, bytes_to_limbs_device: limb j is bits 13 j .. 13 j + 12 of the
// bytes 13j/8 .. 13j/8 + 2, zero past byte 31). No reduction: a value
// >= p stays >= p, so a non-canonical R never equals a frozen y.
TXF_DEV void fe_from_bytes(fe h, const uint8_t* s) {
#pragma unroll
  for (int j = 0; j < TXF_NLIMB; ++j) {
    const int b0 = (13 * j) >> 3;
    const int off = (13 * j) & 7;
    int32_t w = (int32_t)s[b0] | ((int32_t)s[b0 + 1] << 8);
    if (b0 + 2 < 32) w |= (int32_t)s[b0 + 2] << 16;
    h[j] = (w >> off) & TXF_M13;
  }
}

#include "fe_common.cuh"
