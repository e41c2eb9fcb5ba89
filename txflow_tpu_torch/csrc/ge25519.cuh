// edwards25519 point arithmetic for one CUDA thread (K2).
//
// Replaces: txflow_tpu/ops/curve.py (ext_identity, ext_double, pniels_add,
// table_select, table_select_indexed, double_scalar_mul_indexed,
// ext_encode).
//
// Representations follow the JAX package: Extended (X, Y, Z, T) for the
// accumulator and PNiels (Y+X, Y-X, Z, 2dT) for table entries, which
// makes an addition 8 field multiplies. A table entry is one row of
// 4 * TXF_NLIMB int32 (4 coordinates x the field's limbs). The TPU
// selected entries with a one-hot matrix product (an MXU trick); here a
// selection is an indexed load of that row: the base table from
// __constant__ memory, the validator's epoch table from global memory at
// row val_idx*16 + nibble.
//
// What bounds it: field multiplies, 3147 per double-scalar multiply and
// encode (45 per window over 64 windows, plus 267 for the inversion and
// the two affine products). The window loop is not unrolled, so the
// code stays small; each point lives in registers.
//
// One source, two fields: TXF_FE_RADIX=13 (nvcc -DTXF_FE_RADIX=13, the
// library verify13) builds these formulas over the radix-2^13 field of
// fe25519_13.cuh (K8); otherwise over the radix-2^25.5 field of
// fe25519.cuh (K1). The formulas are the same code; only fe and its
// functions differ.
//
// Bounds: radix 2^25.5 -- inputs to every fe_mul stay within 3 carried
// units (see fe25519.cuh): table coordinates are canonical (2 units),
// accumulator coordinates are fe_mul outputs (1 unit), and each formula
// adds or subtracts at most three of them before multiplying. Radix 2^13
// -- fe_add and fe_sub carry their outputs, so every fe_mul input below is
// a normalized product, sum, difference or canonical table coordinate
// (see fe25519_13.cuh); no formula feeds an un-carried sum to fe_mul.
#pragma once
#if defined(TXF_FE_RADIX) && TXF_FE_RADIX == 13
#include "fe25519_13.cuh"
#else
#include "fe25519.cuh"
#endif

struct ge_p3 {
  fe X, Y, Z, T;
};

struct ge_pniels {
  fe YpX, YmX, Z, T2d;
};

TXF_DEV void ge_identity(ge_p3* p) {
  fe_set_small(p->X, 0);
  fe_set_small(p->Y, 1);
  fe_set_small(p->Z, 1);
  fe_set_small(p->T, 0);
}

// Dedicated doubling (dbl-2008-hwcd). r may alias p. T is computed only
// when the next operation is an addition (the doubling formula ignores
// its input T).
TXF_DEV void ge_double(ge_p3* r, const ge_p3* p, bool compute_t) {
  fe A, B, C, E, F, G, H, t;
  fe_sq(A, p->X);
  fe_sq(B, p->Y);
  fe_sq(t, p->Z);
  fe_mul_small(C, t, 2);
  fe_add(H, A, B);
  fe_add(t, p->X, p->Y);
  fe_sq(t, t);
  fe_sub(E, H, t);
  fe_sub(G, A, B);
  fe_add(F, C, G);
  fe_mul(r->X, E, F);
  fe_mul(r->Y, G, H);
  fe_mul(r->Z, F, G);
  if (compute_t) fe_mul(r->T, E, H);
}

// Extended + PNiels -> Extended (madd-2008-hwcd-3 with a general Z2).
// r may alias p.
TXF_DEV void ge_pniels_add(ge_p3* r, const ge_p3* p, const ge_pniels* n) {
  fe A, B, C, D, E, F, G, H, t;
  fe_sub(t, p->Y, p->X);
  fe_mul(A, t, n->YmX);
  fe_add(t, p->Y, p->X);
  fe_mul(B, t, n->YpX);
  fe_mul(C, p->T, n->T2d);
  fe_mul(t, p->Z, n->Z);
  fe_mul_small(D, t, 2);
  fe_sub(E, B, A);
  fe_sub(F, D, C);
  fe_add(G, D, C);
  fe_add(H, B, A);
  fe_mul(r->X, E, F);
  fe_mul(r->Y, G, H);
  fe_mul(r->Z, F, G);
  fe_mul(r->T, E, H);
}

// One table row (4 * TXF_NLIMB int32) -> PNiels entry.
TXF_DEV void ge_load_pniels(ge_pniels* n, const int32_t* row) {
#pragma unroll
  for (int i = 0; i < TXF_NLIMB; ++i) {
    n->YpX[i] = row[i];
    n->YmX[i] = row[TXF_NLIMB + i];
    n->Z[i] = row[2 * TXF_NLIMB + i];
    n->T2d[i] = row[3 * TXF_NLIMB + i];
  }
}

// Canonical encoding pieces: frozen affine y and the parity of frozen x.
TXF_DEV void ge_encode(fe y, int32_t* parity, const ge_p3* p) {
  fe zinv, t, x;
  fe_inv(zinv, p->Z);
  fe_mul(t, p->Y, zinv);
  fe_freeze(y, t);
  fe_mul(t, p->X, zinv);
  fe_freeze(x, t);
  *parity = x[0] & 1;
}
