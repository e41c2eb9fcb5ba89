// Batched ed25519 verification: over device-resident epoch tables (K3)
// and over per-vote gathered tables (K5), plus two kernels that expose K1
// and K2 alone for checking on the card.
//
// Replaces: txflow_tpu/ops/ed25519_batch.py:verify_kernel_gather (K3; and,
// inside it, curve.double_scalar_mul_indexed + curve.ext_encode over the
// field arithmetic of ops/fe.py) and ed25519_batch.py:verify_kernel (K5;
// curve.double_scalar_mul + table_select over one -A table per vote).
//
// One thread checks one signature: P = [S]B + [h](-A) over 64 four-bit
// windows, then accepts iff encode(P) equals the signature's R bytes
// (compared as exact limbs of the raw low 255 bits, so a non-canonical R
// is rejected like Go's byte comparison) and the sign bit matches, ANDed
// with the host pre-checks (S < L, key on curve, first occurrence). K3 and
// K5 differ only in where a thread finds its 16-entry -A table: row
// val_idx of the epoch tables, or its own row of the gathered tables.
//
// Built twice from this one source (ops/_lib.py:LIBS): the library verify
// over the radix-2^25.5 field (K1), and verify13 with -DTXF_FE_RADIX=13
// over the radix-2^13 field (K8, fe25519_13.cuh; tables [V, 16, 4, 20]).
// Each library has its own __constant__ base table in its field's limbs.
//
// What bounds it: integer multiply-adds (about 362k per signature over
// the radix-2^25.5 field, 1.34M 32-bit ones over radix 2^13, see
// ge25519.cuh and the field headers); the inputs are 162 bytes per vote
// plus the epoch tables (160 or 320 bytes a row, V*16 rows, L1/L2-resident
// for any realistic validator set) -- or, for K5, 2560 or 5120 bytes of
// gathered table per vote, still two orders of magnitude under the
// multiply-add time. Design answer: all curve state in registers, one
// thread per signature so there is no cross-thread traffic, and rows
// whose host pre-checks failed (bucket padding, S >= L, off-curve keys,
// in-batch repeats) return at once instead of computing a result that
// the AND would discard.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ge25519.cuh"

#define TXF_ROW (4 * TXF_NLIMB)  // int32 per PNiels table entry

// Base-point table [16][4][TXF_NLIMB], written once per card by
// txf_set_base_table (the host builds it, ops/curve.py:BASE_TABLES).
__constant__ int32_t c_base_table[16 * TXF_ROW];

// [s]B + [h](-A), encoded, with vt the 16 x TXF_ROW window table of -A:
// the shared body of the verify kernels and the dsm_encode kernel. One
// compiled copy (not inlined into each kernel), and one copy of each
// point formula in its window loop (the four doublings and the two
// additions are loops, not unrolled): the code a build compiles stays a
// few dozen field products, whichever field.
__device__ __noinline__ void dsm_encode_row(int i, const uint8_t* __restrict__ s_nib,
                                            const uint8_t* __restrict__ h_nib,
                                            const int32_t* __restrict__ vt, fe y,
                                            int32_t* parity) {
  ge_p3 acc;
  ge_identity(&acc);
  const uint8_t* sn = s_nib + (int64_t)i * 64;
  const uint8_t* hn = h_nib + (int64_t)i * 64;
  ge_pniels n;
#pragma unroll 1
  for (int w = 0; w < 64; ++w) {
#pragma unroll 1
    for (int k = 0; k < 4; ++k) ge_double(&acc, &acc, k == 3);
#pragma unroll 1
    for (int t = 0; t < 2; ++t) {
      if (t == 0)
        ge_load_pniels(&n, c_base_table + (sn[w] & 15) * TXF_ROW);
      else
        ge_load_pniels(&n, vt + (hn[w] & 15) * TXF_ROW);
      ge_pniels_add(&acc, &acc, &n);
    }
  }
  ge_encode(y, parity, &acc);
}

__device__ __forceinline__ int clamp_val(int32_t v, int n_vals) {
  return v < 0 ? 0 : (v >= n_vals ? n_vals - 1 : v);
}

// encode(P) against the signature's raw R: y limbs and the sign bit.
__device__ __forceinline__ int32_t r_matches(int i, const fe y, int32_t parity,
                                             const uint8_t* __restrict__ r_y,
                                             const uint8_t* __restrict__ r_sign) {
  fe r;
  fe_from_bytes(r, r_y + (int64_t)i * 32);
  return (fe_equal(y, r) && parity == (int32_t)r_sign[i]) ? 1 : 0;
}

__global__ void __launch_bounds__(128)
txf_verify_kernel(const uint8_t* __restrict__ s_nib,
                  const uint8_t* __restrict__ h_nib,
                  const int32_t* __restrict__ val_idx,
                  const int32_t* __restrict__ tables, int n_vals,
                  const uint8_t* __restrict__ r_y,
                  const uint8_t* __restrict__ r_sign,
                  const uint8_t* __restrict__ pre_ok,
                  int32_t* __restrict__ out, int B) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  if (!pre_ok[i]) {
    out[i] = 0;
    return;
  }
  fe y;
  int32_t parity;
  dsm_encode_row(i, s_nib, h_nib,
                 tables + (int64_t)clamp_val(val_idx[i], n_vals) * 16 * TXF_ROW,
                 y, &parity);
  out[i] = r_matches(i, y, parity, r_y, r_sign);
}

// K5: the same check with one gathered -A table per vote
// ([B][16][4][TXF_NLIMB]).
__global__ void __launch_bounds__(128)
txf_verify_tables_kernel(const uint8_t* __restrict__ s_nib,
                         const uint8_t* __restrict__ h_nib,
                         const int32_t* __restrict__ a_tables,
                         const uint8_t* __restrict__ r_y,
                         const uint8_t* __restrict__ r_sign,
                         const uint8_t* __restrict__ pre_ok,
                         int32_t* __restrict__ out, int B) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  if (!pre_ok[i]) {
    out[i] = 0;
    return;
  }
  fe y;
  int32_t parity;
  dsm_encode_row(i, s_nib, h_nib, a_tables + (int64_t)i * 16 * TXF_ROW, y,
                 &parity);
  out[i] = r_matches(i, y, parity, r_y, r_sign);
}

__global__ void __launch_bounds__(128)
txf_dsm_encode_kernel(const uint8_t* __restrict__ s_nib,
                      const uint8_t* __restrict__ h_nib,
                      const int32_t* __restrict__ val_idx,
                      const int32_t* __restrict__ tables, int n_vals,
                      int32_t* __restrict__ y_out,
                      int32_t* __restrict__ parity_out, int B) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  fe y;
  int32_t parity;
  dsm_encode_row(i, s_nib, h_nib,
                 tables + (int64_t)clamp_val(val_idx[i], n_vals) * 16 * TXF_ROW,
                 y, &parity);
#pragma unroll
  for (int l = 0; l < TXF_NLIMB; ++l) y_out[(int64_t)i * TXF_NLIMB + l] = y[l];
  parity_out[i] = parity;
}

// Per element: frozen mul(a,b), sq(a), sub(a,b), inv(a), and freeze(a),
// written as out[i][5][TXF_NLIMB].
__global__ void txf_fe_ops_kernel(const int32_t* __restrict__ a,
                                  const int32_t* __restrict__ b,
                                  int32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fe fa, fb, t, r;
#pragma unroll
  for (int l = 0; l < TXF_NLIMB; ++l) {
    fa[l] = a[(int64_t)i * TXF_NLIMB + l];
    fb[l] = b[(int64_t)i * TXF_NLIMB + l];
  }
  int32_t* o = out + (int64_t)i * 5 * TXF_NLIMB;
  fe_mul(t, fa, fb);
  fe_freeze(r, t);
#pragma unroll
  for (int l = 0; l < TXF_NLIMB; ++l) o[l] = r[l];
  fe_sq(t, fa);
  fe_freeze(r, t);
#pragma unroll
  for (int l = 0; l < TXF_NLIMB; ++l) o[1 * TXF_NLIMB + l] = r[l];
  fe_sub(t, fa, fb);
  fe_freeze(r, t);
#pragma unroll
  for (int l = 0; l < TXF_NLIMB; ++l) o[2 * TXF_NLIMB + l] = r[l];
  fe_inv(t, fa);
  fe_freeze(r, t);
#pragma unroll
  for (int l = 0; l < TXF_NLIMB; ++l) o[3 * TXF_NLIMB + l] = r[l];
  fe_freeze(r, fa);
#pragma unroll
  for (int l = 0; l < TXF_NLIMB; ++l) o[4 * TXF_NLIMB + l] = r[l];
}

static inline int grid_for(int n, int threads) {
  return (n + threads - 1) / threads;
}

extern "C" {

int txf_set_base_table(const int32_t* host_table) {
  return (int)cudaMemcpyToSymbol(c_base_table, host_table,
                                 sizeof(c_base_table));
}

int txf_verify(const uint8_t* s_nib, const uint8_t* h_nib,
               const int32_t* val_idx, const int32_t* tables, int n_vals,
               const uint8_t* r_y, const uint8_t* r_sign,
               const uint8_t* pre_ok, int32_t* out, int B, void* stream) {
  if (B <= 0) return 0;
  txf_verify_kernel<<<grid_for(B, 128), 128, 0, (cudaStream_t)stream>>>(
      s_nib, h_nib, val_idx, tables, n_vals, r_y, r_sign, pre_ok, out, B);
  return (int)cudaGetLastError();
}

int txf_verify_tables(const uint8_t* s_nib, const uint8_t* h_nib,
                      const int32_t* a_tables, const uint8_t* r_y,
                      const uint8_t* r_sign, const uint8_t* pre_ok,
                      int32_t* out, int B, void* stream) {
  if (B <= 0) return 0;
  txf_verify_tables_kernel<<<grid_for(B, 128), 128, 0, (cudaStream_t)stream>>>(
      s_nib, h_nib, a_tables, r_y, r_sign, pre_ok, out, B);
  return (int)cudaGetLastError();
}

int txf_dsm_encode(const uint8_t* s_nib, const uint8_t* h_nib,
                   const int32_t* val_idx, const int32_t* tables, int n_vals,
                   int32_t* y_out, int32_t* parity_out, int B, void* stream) {
  if (B <= 0) return 0;
  txf_dsm_encode_kernel<<<grid_for(B, 128), 128, 0, (cudaStream_t)stream>>>(
      s_nib, h_nib, val_idx, tables, n_vals, y_out, parity_out, B);
  return (int)cudaGetLastError();
}

int txf_fe_ops(const int32_t* a, const int32_t* b, int32_t* out, int n,
               void* stream) {
  if (n <= 0) return 0;
  txf_fe_ops_kernel<<<grid_for(n, 128), 128, 0, (cudaStream_t)stream>>>(
      a, b, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
