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
// has a 32x32->64 integer multiply-add, so a product is 100 such
// multiply-adds into ten int64 column sums followed by one carry chain.
//
// What bounds it: integer multiply-adds. fe_mul is 100 IMAD.WIDE plus 14
// pre-scalings; everything else is adds, shifts and the carry chain. The
// design keeps every field element in registers (fully unrolled limb
// loops) so the only memory traffic of the verify kernel is its inputs and
// the epoch-table rows it selects.
//
// Bounds (ref10's, in units of the carried bound 1.1*2^25 / 1.1*2^24 per
// even / odd limb): fe_reduce output is 1 unit; fe_mul accepts inputs up to
// 3 units (1.65*2^26 / 1.65*2^25), so a sum or difference of three carried
// values may feed a multiply without a carry. The curve formulas in
// ge25519.cuh never exceed that. fe_freeze accepts 1.1*2^26 / 1.1*2^25.
//
// The plain PyTorch version of every function here is in
// txflow_tpu_torch/ops/fe.py and follows the same operation order. The
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

// Rounding carry of limb i into limb i+1 (limb 9 wraps into limb 0 times
// 19, since 2^255 = 19 mod p). Arithmetic shifts; the subtraction is
// written as a multiply so that no negative value is left-shifted.
#define TXF_CARRY(t, i, w)                                      \
  do {                                                          \
    int64_t c_ = ((t)[i] + ((int64_t)1 << ((w) - 1))) >> (w);   \
    (t)[(i) + 1] += c_;                                         \
    (t)[i] -= c_ * ((int64_t)1 << (w));                         \
  } while (0)

// ref10 carry chain: int64 column sums -> carried int32 limbs (1 unit).
TXF_DEV void fe_reduce(fe h, int64_t t[10]) {
  TXF_CARRY(t, 0, 26);
  TXF_CARRY(t, 4, 26);
  TXF_CARRY(t, 1, 25);
  TXF_CARRY(t, 5, 25);
  TXF_CARRY(t, 2, 26);
  TXF_CARRY(t, 6, 26);
  TXF_CARRY(t, 3, 25);
  TXF_CARRY(t, 7, 25);
  TXF_CARRY(t, 4, 26);
  TXF_CARRY(t, 8, 26);
  {
    int64_t c9 = (t[9] + ((int64_t)1 << 24)) >> 25;
    t[0] += c9 * 19;
    t[9] -= c9 * ((int64_t)1 << 25);
  }
  TXF_CARRY(t, 0, 26);
#pragma unroll
  for (int i = 0; i < 10; ++i) h[i] = (int32_t)t[i];
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
  for (int k = 0; k < 10; ++k) t[k] = 0;
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

TXF_DEV void fe_sq(fe h, const fe f) { fe_mul(h, f, f); }

// h = f * c for a small constant c (|c| < 2^6); output carried.
TXF_DEV void fe_mul_small(fe h, const fe f, int32_t c) {
  int64_t t[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) t[i] = (int64_t)f[i] * c;
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
