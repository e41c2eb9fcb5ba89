// The radix-independent part of a GF(2^255-19) field for one CUDA thread,
// included at the end of each field header (fe25519.cuh: ten radix-2^25.5
// limbs; fe25519_13.cuh: twenty radix-2^13 limbs), which defines TXF_NLIMB,
// the type fe and fe_mul / fe_sq.
//
// Replaces: txflow_tpu/ops/_fe_common.py (make_inv -> fe_inv,
// fe_is_equal_frozen -> fe_equal), the part the JAX package shares
// between its two fields too.
#pragma once

TXF_DEV void fe_copy(fe h, const fe f) {
#pragma unroll
  for (int i = 0; i < TXF_NLIMB; ++i) h[i] = f[i];
}

TXF_DEV void fe_set_small(fe h, int32_t v) {
#pragma unroll
  for (int i = 0; i < TXF_NLIMB; ++i) h[i] = 0;
  h[0] = v;
}

// x^(2^k) by k squarings, one squaring in the code (a loop, not
// unrolled: the chain below calls it eleven times).
TXF_DEV void fe_pow2k(fe h, const fe f, int k) {
  fe_copy(h, f);
#pragma unroll 1
  for (int i = 0; i < k; ++i) fe_sq(h, h);
}

// out = z^(p-2): the 25519 addition chain (254 squarings, 11 multiplies),
// in the order of txflow_tpu/ops/_fe_common.py:make_inv. Not inlined: a
// signature inverts once, and one compiled copy of the chain, called from
// every kernel, keeps the build of the 20-limb field short (its fe_mul is
// four times K1's code).
__device__ __noinline__ void fe_inv(fe out, const fe z) {
  fe z2, z9, z11, z2_5_0, z2_10_0, z2_20_0, z2_50_0, z2_100_0, t;
  fe_sq(z2, z);
  fe_pow2k(t, z2, 2);
  fe_mul(z9, t, z);
  fe_mul(z11, z9, z2);
  fe_sq(t, z11);
  fe_mul(z2_5_0, t, z9);
  fe_pow2k(t, z2_5_0, 5);
  fe_mul(z2_10_0, t, z2_5_0);
  fe_pow2k(t, z2_10_0, 10);
  fe_mul(z2_20_0, t, z2_10_0);
  fe_pow2k(t, z2_20_0, 20);
  fe_mul(t, t, z2_20_0);  // 2^40 - 2^0
  fe_pow2k(t, t, 10);
  fe_mul(z2_50_0, t, z2_10_0);
  fe_pow2k(t, z2_50_0, 50);
  fe_mul(z2_100_0, t, z2_50_0);
  fe_pow2k(t, z2_100_0, 100);
  fe_mul(t, t, z2_100_0);  // 2^200 - 2^0
  fe_pow2k(t, t, 50);
  fe_mul(t, t, z2_50_0);  // 2^250 - 2^0
  fe_pow2k(t, t, 5);
  fe_mul(out, t, z11);  // 2^255 - 21
}

TXF_DEV bool fe_equal(const fe a, const fe b) {
  int32_t d = 0;
#pragma unroll
  for (int i = 0; i < TXF_NLIMB; ++i) d |= a[i] ^ b[i];
  return d == 0;
}
