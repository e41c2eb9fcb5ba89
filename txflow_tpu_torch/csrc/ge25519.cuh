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
// selection is an indexed load of that row: the base table from shared
// memory (staged per block from a device tensor), the validator's epoch
// table from global memory at row val_idx*16 + nibble.
//
// What bounds it: field multiplies, 3147 per double-scalar multiply and
// encode in one thread (45 per window over 64 windows, plus 267 for the
// inversion and the two affine products). No kernel runs them in one
// thread any more; verify.cu runs every signature on four lanes, in one
// of two ways. By scalar quarter (K3, K6: txf_verify_kernel), each lane
// runs these formulas whole over 16 windows and two combine rounds
// (ge_p3_to_pniels + ge_pniels_add), 709 products, then a second launch's
// encode, 267. By coordinate (K5, K2: txf_coord_dsm_kernel), the four
// lanes hold X, Y, Z and T and each computes one of the four independent
// products of a round of ge_double or ge_pniels_add -- the same field
// operations on the same operands as the functions below, so the bounds
// that follow hold there too -- 12 products a window over 64 windows, then
// the encode in a second launch. The window loops are not unrolled, so the
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

// 2d in canonical limbs of the field (ops/curve.py:D2_INT).
TXF_DEV void fe_set_d2(fe h) {
#if defined(TXF_FE_RADIX) && TXF_FE_RADIX == 13
  const int32_t k[TXF_NLIMB] = {4441, 5527, 1289, 3383, 3773, 6315, 2574,
                                4944, 20,   7,    5196, 7655, 3886, 1856,
                                7270, 8092, 5855, 3810, 438,  72};
#else
  const int32_t k[TXF_NLIMB] = {45281625, 27714825, 36363642, 13898781,
                                229458,   15978800, 54557047, 27058993,
                                29715967, 9444199};
#endif
#pragma unroll
  for (int i = 0; i < TXF_NLIMB; ++i) h[i] = k[i];
}

// Extended -> PNiels (Y+X, Y-X, Z, 2d T): one product. The combine
// rounds of the four-lane verify kernel add a partner lane's point to
// their own with ge_pniels_add after this conversion, so an addition of
// two Extended points is this product plus ge_pniels_add's 8 (the unified
// formula: complete on the whole curve, doubling and identity included).
// Bounds: Y+X and Y-X of fe_mul outputs are 2 carried units over radix
// 2^25.5 (ge_pniels_add's inputs from a table are 2 units too), and
// normalized over radix 2^13 (fe_add and fe_sub carry there); T * 2d is a
// product of a fe_mul output and a canonical constant.
TXF_DEV void ge_p3_to_pniels(ge_pniels* n, const ge_p3* p) {
  fe d2;
  fe_set_d2(d2);
  fe_add(n->YpX, p->Y, p->X);
  fe_sub(n->YmX, p->Y, p->X);
  fe_copy(n->Z, p->Z);
  fe_mul(n->T2d, p->T, d2);
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
