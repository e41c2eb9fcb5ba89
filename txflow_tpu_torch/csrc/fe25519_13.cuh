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
// What bounds it: integer multiply-adds (427 a product, see
// ops/fe13.py:MADS_PER_MUL) and registers: a product holds its 39 column
// sums and both inputs (79 registers), a point 80. The limb loops are
// fully unrolled so every array stays in registers as far as the 255 a
// thread allow; the rest spills to local memory (ptxas -v says how much).
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

// h = f * g mod p for normalized f, g. h may alias f or g.
TXF_DEV void fe_mul(fe h, const fe f, const fe g) {
  int32_t c[2 * TXF_NLIMB - 1];
#pragma unroll
  for (int k = 0; k < 2 * TXF_NLIMB - 1; ++k) c[k] = 0;
#pragma unroll
  for (int i = 0; i < TXF_NLIMB; ++i) {
#pragma unroll
    for (int j = 0; j < TXF_NLIMB; ++j) c[i + j] += f[i] * g[j];
  }
  // columns 20..38 (and a zero 40th) carried 3 passes before the fold
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

TXF_DEV void fe_sq(fe h, const fe f) { fe_mul(h, f, f); }

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
