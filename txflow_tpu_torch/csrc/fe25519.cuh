// GF(2^255-19) arithmetic for one CUDA thread (K1).
//
// Replaces: txflow_tpu/ops/fe.py (fe_carry, fe_add, fe_sub, fe_mul, fe_sq,
// fe_mul_small, fe_freeze, bytes_to_limbs_device) and
// txflow_tpu/ops/_fe_common.py (fe_is_equal_frozen, fe_parity_frozen,
// make_inv -> fe_inv).
//
// Layout: ten signed int32 limbs in radix 2^25.5 (ref10): limb i holds bits
// [OFF[i], OFF[i] + W[i]) with W = 26, 25, 26, 25, ... The TPU kernel used
// 32 radix-2^8 limbs because its vector unit has no wide multiply; Hopper
// has a 32x32->64 integer multiply-add, so a product is 32x32->64
// multiply-adds into ten int64 column sums followed by one carry chain.
//
// What bounds it: the integer pipe's issue slots and, where a grid is a
// few warps, one product's dependence depth. The design keeps every field
// element in registers (fully unrolled limb loops) so the only memory
// traffic of the verify kernel is its inputs and the epoch-table rows it
// selects. Costs (ops/fe.py:MADS_PER_MUL = 115 and MADS_PER_SQ = 68, the
// multiply-adds each bound counts):
//   fe_mul  100 wide multiply-adds (IMAD.WIDE) and 14 int32 prescales
//           (2 f_i for odd i, 19 g_j), then fe_reduce;
//   fe_sq   55 wide multiply-adds (ref10's squaring: 10 squares and 45
//           cross terms taken once with their factor 2) and 13 prescales
//           (2 f_i for i < 8; 19 f_6, 19 f_8; 38 f_5, 38 f_7, 38 f_9), then
//           fe_reduce. Its column sums are fe_mul(f, f)'s, term for term
//           (f_i f_j and f_j f_i folded into one), so its limbs are too;
//   fe_reduce 12 carries, 7 deep: a 64-bit shift and a 64-bit add each
//           (the second carries of limbs 4 and 0 add an int32), and a
//           32-bit mask and add for each remainder.
// Built by nvcc for sm_90a, one fe_mul is 175 SASS instructions (100
// IMAD.WIDE) and one fe_sq 131 (55 IMAD.WIDE), where fe_sq as fe_mul(f, f)
// over ref10's unbiased carry took 191 and 196 (probe kernels of
// txflow_tpu_torch/parent_ab.py --kernels-ab, NVIDIA H100).
//
// Prescale bound (tight): at the 3-unit input bound below, 38 * 1.65*2^25
// and 19 * 1.65*2^26 are about 2.104e9 < 2^31, fe_mul's g19 and fe_sq's
// 19/38 prescales alike; 2 f_i is below 2^29.
//
// Bounds (ref10's, in units of the carried bound 1.1*2^25 / 1.1*2^24 per
// even / odd limb): fe_reduce output is 1 unit; fe_mul and fe_sq accept
// inputs up to 3 units (1.65*2^26 / 1.65*2^25), so a sum or difference of
// three carried values may feed a multiply without a carry. The curve
// formulas in ge25519.cuh never exceed that. fe_freeze accepts
// 1.1*2^26 / 1.1*2^25.
//
// The carry's invariant: every column sum enters fe_reduce already biased
// by 2^(W[k]-1), the rounding constant of its first carry (fe_mul, fe_sq
// and fe_mul_small start each column at it; in SASS it joins the 3-input
// add that takes the carry in, not a step of its own on the chain), and
// fe_reduce computes ref10's rounding carry chain on the
// unbiased sums exactly: the carry out of a biased column is its
// arithmetic shift, and its remainder, which fits in W[k] bits, comes from
// the low 32-bit word alone. Same integers in, same limbs out as the
// plain fe_reduce (ops/fe.py), which carries unbiased sums one rounding
// carry at a time.
//
// The plain PyTorch version of every function here is in
// txflow_tpu_torch/ops/fe.py and computes the same column sums (its fe_sq
// is fe_mul(f, f), whose columns the squaring above equals term for
// term). The
// radix-independent functions (copy, constants, the inversion chain,
// equality) are in fe_common.cuh, shared with the radix-2^13 field.
#pragma once
#include <stdint.h>

#ifndef TXF_DEV
#define TXF_DEV __device__ __forceinline__
#endif

#define TXF_NLIMB 10
typedef int32_t fe[TXF_NLIMB];

TXF_DEV void fe_add(fe h, const fe f, const fe g) {
#pragma unroll
  for (int i = 0; i < 10; ++i) h[i] = f[i] + g[i];
}

TXF_DEV void fe_sub(fe h, const fe f, const fe g) {
#pragma unroll
  for (int i = 0; i < 10; ++i) h[i] = f[i] - g[i];
}

// The rounding bias of column k: 2^(W[k] - 1), the constant ref10's carry
// adds before its shift, folded into the column's first term.
#define TXF_BIAS(k) ((int64_t)1 << (((k) & 1) ? 24 : 25))

// (u mod 2^w) - 2^(w-1): the remainder of a biased column u after its carry
// u >> w, in [-2^(w-1), 2^(w-1)), from u's low word alone.
TXF_DEV int32_t fe_rem(int64_t u, int w) {
  return (int32_t)((uint32_t)u & ((1u << w) - 1)) - ((int32_t)1 << (w - 1));
}

// ref10 carry chain over biased int64 column sums (u[k] = column k +
// TXF_BIAS(k)) -> carried int32 limbs (1 unit). The order of ref10's
// carries: 0 4 1 5 2 6 3 7 4 8 9(x19 into 0) 0. Limbs 4 and 0 are carried
// twice; their second carry starts from the biased remainder of the first
// (b4, b0: below 2^26) plus the carry in, and moves a value below 2^16,
// added to limbs 5 and 1 in int32.
TXF_DEV void fe_reduce(fe h, int64_t u[10]) {
  u[1] += u[0] >> 26;
  u[5] += u[4] >> 26;
  const uint32_t b0 = (uint32_t)u[0] & 0x3ffffffu;
  const uint32_t b4 = (uint32_t)u[4] & 0x3ffffffu;
  u[2] += u[1] >> 25;
  h[1] = fe_rem(u[1], 25);
  u[6] += u[5] >> 25;
  h[5] = fe_rem(u[5], 25);
  u[3] += u[2] >> 26;
  h[2] = fe_rem(u[2], 26);
  u[7] += u[6] >> 26;
  h[6] = fe_rem(u[6], 26);
  const int64_t v4 = (int64_t)b4 + (u[3] >> 25);
  h[3] = fe_rem(u[3], 25);
  u[8] += u[7] >> 25;
  h[7] = fe_rem(u[7], 25);
  h[5] += (int32_t)(v4 >> 26);
  h[4] = fe_rem(v4, 26);
  u[9] += u[8] >> 26;
  h[8] = fe_rem(u[8], 26);
  const int64_t v0 = (int64_t)b0 + 19 * (u[9] >> 25);
  h[9] = fe_rem(u[9], 25);
  h[1] += (int32_t)(v0 >> 26);
  h[0] = fe_rem(v0, 26);
}

// h = f * g mod p. h may alias f or g.
TXF_DEV void fe_mul(fe h, const fe f, const fe g) {
  int32_t f2[10], g19[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    f2[i] = (i & 1) ? 2 * f[i] : f[i];
    g19[i] = 19 * g[i];
  }
  int64_t t[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) t[k] = TXF_BIAS(k);
  // i outer, j inner: consecutive multiply-adds go to ten different
  // columns, so no two in a row depend on each other
#pragma unroll
  for (int i = 0; i < 10; ++i) {
#pragma unroll
    for (int j = 0; j < 10; ++j) {
      // column i+j; odd*odd limb products carry an extra factor 2 (the
      // half-bit of radix 2^25.5); columns >= 10 fold back times 19
      const int32_t a = ((i & 1) && (j & 1)) ? f2[i] : f[i];
      const int32_t b = (i + j >= 10) ? g19[j] : g[j];
      t[(i + j) % 10] += (int64_t)a * (int64_t)b;
    }
  }
  fe_reduce(h, t);
}

#define TXF_M(a, b) ((int64_t)(a) * (int64_t)(b))

// h = f^2 mod p, ref10's squaring: column k of fe_mul(f, f) with each pair
// i < j taken once at twice its factor. h may alias f. Every prescale is a
// product of a limb by 2, 19 or 38 and fits in int32 (header comment).
TXF_DEV void fe_sq(fe h, const fe f) {
  const int32_t f0 = f[0], f1 = f[1], f2 = f[2], f3 = f[3], f4 = f[4];
  const int32_t f5 = f[5], f6 = f[6], f7 = f[7], f8 = f[8], f9 = f[9];
  const int32_t f0_2 = 2 * f0, f1_2 = 2 * f1, f2_2 = 2 * f2, f3_2 = 2 * f3;
  const int32_t f4_2 = 2 * f4, f5_2 = 2 * f5, f6_2 = 2 * f6, f7_2 = 2 * f7;
  const int32_t f5_38 = 38 * f5, f6_19 = 19 * f6, f7_38 = 38 * f7;
  const int32_t f8_19 = 19 * f8, f9_38 = 38 * f9;
  int64_t t[10];
  t[0] = TXF_BIAS(0) + TXF_M(f0, f0) + TXF_M(f1_2, f9_38) + TXF_M(f2_2, f8_19) +
         TXF_M(f3_2, f7_38) + TXF_M(f4_2, f6_19) + TXF_M(f5, f5_38);
  t[1] = TXF_BIAS(1) + TXF_M(f0_2, f1) + TXF_M(f2, f9_38) + TXF_M(f3_2, f8_19) +
         TXF_M(f4, f7_38) + TXF_M(f5_2, f6_19);
  t[2] = TXF_BIAS(2) + TXF_M(f0_2, f2) + TXF_M(f1_2, f1) + TXF_M(f3_2, f9_38) +
         TXF_M(f4_2, f8_19) + TXF_M(f5_2, f7_38) + TXF_M(f6, f6_19);
  t[3] = TXF_BIAS(3) + TXF_M(f0_2, f3) + TXF_M(f1_2, f2) + TXF_M(f4, f9_38) +
         TXF_M(f5_2, f8_19) + TXF_M(f6, f7_38);
  t[4] = TXF_BIAS(4) + TXF_M(f0_2, f4) + TXF_M(f1_2, f3_2) + TXF_M(f2, f2) +
         TXF_M(f5_2, f9_38) + TXF_M(f6_2, f8_19) + TXF_M(f7, f7_38);
  t[5] = TXF_BIAS(5) + TXF_M(f0_2, f5) + TXF_M(f1_2, f4) + TXF_M(f2_2, f3) +
         TXF_M(f6, f9_38) + TXF_M(f7_2, f8_19);
  t[6] = TXF_BIAS(6) + TXF_M(f0_2, f6) + TXF_M(f1_2, f5_2) + TXF_M(f2_2, f4) +
         TXF_M(f3_2, f3) + TXF_M(f7_2, f9_38) + TXF_M(f8, f8_19);
  t[7] = TXF_BIAS(7) + TXF_M(f0_2, f7) + TXF_M(f1_2, f6) + TXF_M(f2_2, f5) +
         TXF_M(f3_2, f4) + TXF_M(f8, f9_38);
  t[8] = TXF_BIAS(8) + TXF_M(f0_2, f8) + TXF_M(f1_2, f7_2) + TXF_M(f2_2, f6) +
         TXF_M(f3_2, f5_2) + TXF_M(f4, f4) + TXF_M(f9, f9_38);
  t[9] = TXF_BIAS(9) + TXF_M(f0_2, f9) + TXF_M(f1_2, f8) + TXF_M(f2_2, f7) +
         TXF_M(f3_2, f6) + TXF_M(f4_2, f5);
  fe_reduce(h, t);
}

// h = f * c for a small constant c (|c| < 2^6); output carried.
TXF_DEV void fe_mul_small(fe h, const fe f, int32_t c) {
  int64_t t[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) t[i] = (int64_t)f[i] * c + TXF_BIAS(i);
  fe_reduce(h, t);
}

// Exact canonical reduction (ref10 fe_tobytes): limbs in [0, 2^W[i]) and
// value < p. q = floor(h / p) is computed first, then h - q*p by a floor
// carry chain that drops bit 255.
TXF_DEV void fe_freeze(fe out, const fe f) {
  int32_t h[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) h[i] = f[i];
  int32_t q = (19 * h[9] + ((int32_t)1 << 24)) >> 25;
#pragma unroll
  for (int i = 0; i < 10; ++i) q = (h[i] + q) >> ((i & 1) ? 25 : 26);
  h[0] += 19 * q;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const int w = (i & 1) ? 25 : 26;
    const int32_t c = h[i] >> w;
    h[i + 1] += c;
    h[i] -= c * ((int32_t)1 << w);
  }
  {
    const int32_t c = h[9] >> 25;
    h[9] -= c * ((int32_t)1 << 25);
  }
#pragma unroll
  for (int i = 0; i < 10; ++i) out[i] = h[i];
}

// Low 255 bits of a 32-byte little-endian string -> exact limbs (no
// reduction: a value >= p stays >= p, so a non-canonical R never equals a
// frozen y).
TXF_DEV void fe_from_bytes(fe h, const uint8_t* s) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const int off = (i >> 1) * 51 + ((i & 1) ? 26 : 0);
    const int w = (i & 1) ? 25 : 26;
    const int byte = off >> 3;
    uint64_t v = 0;
#pragma unroll
    for (int k = 0; k < 5; ++k)
      if (byte + k < 32) v |= (uint64_t)s[byte + k] << (8 * k);
    h[i] = (int32_t)((v >> (off & 7)) & ((1u << w) - 1));
  }
}

#include "fe_common.cuh"
