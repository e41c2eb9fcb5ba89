// Batched ed25519 verification: over device-resident epoch tables (K3)
// and over per-vote gathered tables (K5), plus two kernels that expose K1
// and K2 alone for checking on the card.
//
// Replaces: txflow_tpu/ops/ed25519_batch.py:verify_kernel_gather (K3; and,
// inside it, curve.double_scalar_mul_indexed + curve.ext_encode over the
// field arithmetic of ops/fe.py) and ed25519_batch.py:verify_kernel (K5;
// curve.double_scalar_mul + table_select over one -A table per vote).
//
// Each kernel checks P = [S]B + [h](-A), then accepts iff encode(P)
// equals the signature's R bytes (compared as exact limbs of the raw low
// 255 bits, so a non-canonical R is rejected like Go's byte comparison)
// and the sign bit matches, ANDed with the host pre-checks (S < L, key on
// curve, first occurrence).
//
// K3 (txf_verify, also K6's launch) runs four lanes a signature: lane j
// of a group of four consecutive lanes takes quarter j of both scalars
// (bits [64j, 64j + 64), nibbles [48 - 16j, 64 - 16j) of the MSB-first
// nibbles), so [S]B + [h](-A) = sum_j [S_j] 2^(64j) B + [h_j] 2^(64j) (-A)
// over 16 windows each, with the quarter-j tables of B (staged per block
// in shared memory from a device tensor) and of -A (row val_idx of the
// epoch's tables for j = 0, of its quarter tables for j = 1..3). Two
// butterfly rounds of shuffles within the group (xor 1, then xor 2) add
// the lanes' points (ge_p3_to_pniels + ge_pniels_add), lane 0 stores the
// sum, and a second launch encodes and compares it, one thread a row.
// K5 (txf_verify_tables) and the K2 check kernel
// (txf_dsm_encode) keep one thread a signature over 64 windows (the body
// dsm_encode_row, base table in __constant__ memory); K3 and K5 differ
// in where a -A table comes from: the epoch tables, or the row's own
// gathered table.
//
// Built twice from this one source (ops/_lib.py:LIBS): the library verify
// over the radix-2^25.5 field (K1), and verify13 with -DTXF_FE_RADIX=13
// over the radix-2^13 field (K8, fe25519_13.cuh; tables [V, 16, 4, 20]).
// Each library has its own __constant__ base table in its field's limbs;
// the quarter split is at the point level, so both fields take it from
// this source.
//
// What bounds it: integer multiply-adds (3147 field products a signature
// in one thread, about 362k 32-bit multiply-adds over the radix-2^25.5
// field, 1.34M over radix 2^13; the four-lane form does 3103, see
// ops/curve.py:MULS_PER_QUARTER_DSM_ENCODE); the inputs are 162 bytes per
// vote plus the epoch tables (L1/L2-resident for any realistic validator
// set) -- or, for K5, 2560 or 5120 bytes of gathered table per vote, still
// two orders of magnitude under the multiply-add time. But no batch the
// engine sends keeps the card's multiply-add units busy: one thread's
// chain of 3147 dependent products is the kernel's time at 8 rows (one
// warp) and still at 16,384 (512 warps on 132 SMs, about one warp a
// scheduler, 188 registers a thread: nothing to issue while a product's
// latency runs). Design answer: the quarter split shortens one lane's
// chain to about 976 products (16 windows of 45 less the first window's
// 29 doublings of the identity, two combine rounds of 9, then the
// encode's 267 in the second launch) for 1% less work (3103 products a
// signature), and puts four times the warps on the schedulers; splitting
// a field product over lanes would cost more shuffles than it saves. At
// 16384 rows the card is then busy, and the encode runs one thread a row
// so that a warp pays its serial chain for 32 rows, not 8. The base
// quarters move from __constant__ to
// shared memory: a warp's lanes read up to 16 different entries, which
// the constant cache serves one address at a time. All curve state stays
// in registers, and rows whose host pre-checks failed (bucket padding,
// S >= L, off-curve keys, in-batch repeats) return at once, a whole group
// together, instead of computing a result that the AND would discard.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ge25519.cuh"

#define TXF_ROW (4 * TXF_NLIMB)  // int32 per PNiels table entry
#define TXF_QUARTERS 4
#define TXF_QWINDOWS 16  // windows a lane runs: 64 bits of each scalar

// Base-point table [16][4][TXF_NLIMB] of the one-lane kernels (K5, the K2
// check kernel), written once per card by txf_set_base_table (the host
// builds it, ops/curve.py:BASE_TABLES).
__constant__ int32_t c_base_table[16 * TXF_ROW];

// [s]B + [h](-A), encoded, in one thread, with vt the 16 x TXF_ROW window
// table of -A: the shared body of K5 and the dsm_encode kernel. One
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

// The partner lane's point (lane ^ r within the group of four).
__device__ __forceinline__ void ge_shfl_xor(ge_p3* q, const ge_p3* p, int r,
                                            unsigned mask) {
#pragma unroll
  for (int l = 0; l < TXF_NLIMB; ++l) {
    q->X[l] = __shfl_xor_sync(mask, p->X[l], r, TXF_QUARTERS);
    q->Y[l] = __shfl_xor_sync(mask, p->Y[l], r, TXF_QUARTERS);
    q->Z[l] = __shfl_xor_sync(mask, p->Z[l], r, TXF_QUARTERS);
    q->T[l] = __shfl_xor_sync(mask, p->T[l], r, TXF_QUARTERS);
  }
}

// K3, first launch: four consecutive lanes a row (lane j = quarter j),
// blockDim / 4 rows a block. base_quarters [4][16][TXF_ROW]; tables
// [V][16][TXF_ROW] (quarter 0); quarter_tables [V][3][16][TXF_ROW]
// (quarters 1-3). Lane 0 of each group writes the row's sum P = [S]B +
// [h](-A) as (X, Y, Z) into points [B][3][TXF_NLIMB]; a row whose
// pre-checks failed writes nothing.
__global__ void __launch_bounds__(128)
txf_verify_kernel(const uint8_t* __restrict__ s_nib,
                  const uint8_t* __restrict__ h_nib,
                  const int32_t* __restrict__ val_idx,
                  const int32_t* __restrict__ tables,
                  const int32_t* __restrict__ quarter_tables, int n_vals,
                  const int32_t* __restrict__ base_quarters,
                  const uint8_t* __restrict__ pre_ok,
                  int32_t* __restrict__ points, int B) {
  __shared__ int32_t s_base[TXF_QUARTERS * 16 * TXF_ROW];
  for (int k = threadIdx.x; k < TXF_QUARTERS * 16 * TXF_ROW; k += blockDim.x)
    s_base[k] = base_quarters[k];
  __syncthreads();
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = t >> 2;
  const int j = t & 3;
  // a group's four lanes share i: they leave together, and every shuffle
  // below names only the group's lanes
  if (i >= B || !pre_ok[i]) return;
  const int v = clamp_val(val_idx[i], n_vals);
  const int32_t* bt = s_base + j * 16 * TXF_ROW;
  const int32_t* vt =
      j == 0 ? tables + (int64_t)v * 16 * TXF_ROW
             : quarter_tables + ((int64_t)v * (TXF_QUARTERS - 1) + (j - 1)) * 16 * TXF_ROW;
  const int off = 64 - TXF_QWINDOWS * (j + 1);
  const uint8_t* sn = s_nib + (int64_t)i * 64 + off;
  const uint8_t* hn = h_nib + (int64_t)i * 64 + off;
  ge_p3 acc;
  ge_identity(&acc);
  ge_pniels n;
#pragma unroll 1
  for (int w = 0; w < TXF_QWINDOWS; ++w) {
    // the first window's doublings would double the identity: skipped
#pragma unroll 1
    for (int k = w ? 0 : 4; k < 4; ++k) ge_double(&acc, &acc, k == 3);
#pragma unroll 1
    for (int u = 0; u < 2; ++u) {
      if (u == 0)
        ge_load_pniels(&n, bt + (sn[w] & 15) * TXF_ROW);
      else
        ge_load_pniels(&n, vt + (hn[w] & 15) * TXF_ROW);
      ge_pniels_add(&acc, &acc, &n);
    }
  }
  // combine: lane j adds lane j^1's point, then lane j^2's; lane 0 ends
  // with (Q0 + Q1) + (Q2 + Q3)
  const unsigned mask = 0xFu << (threadIdx.x & 28);
#pragma unroll 1
  for (int r = 1; r < TXF_QUARTERS; r <<= 1) {
    ge_p3 q;
    ge_shfl_xor(&q, &acc, r, mask);
    ge_p3_to_pniels(&n, &q);
    ge_pniels_add(&acc, &acc, &n);
  }
  if (j == 0) {
    int32_t* o = points + (int64_t)i * 3 * TXF_NLIMB;
#pragma unroll
    for (int l = 0; l < TXF_NLIMB; ++l) {
      o[l] = acc.X[l];
      o[TXF_NLIMB + l] = acc.Y[l];
      o[2 * TXF_NLIMB + l] = acc.Z[l];
    }
  }
}

// K3, second launch: one thread a row encodes P and compares it with R
// (the encode is one serial chain of 267 products: in the first launch
// three of a group's four lanes would idle through it, so a warp would
// pay it for 8 rows instead of 32).
__global__ void __launch_bounds__(128)
txf_verify_encode_kernel(const int32_t* __restrict__ points,
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
  const int32_t* o = points + (int64_t)i * 3 * TXF_NLIMB;
  ge_p3 p;
#pragma unroll
  for (int l = 0; l < TXF_NLIMB; ++l) {
    p.X[l] = o[l];
    p.Y[l] = o[TXF_NLIMB + l];
    p.Z[l] = o[2 * TXF_NLIMB + l];
  }
  fe y;
  int32_t parity;
  ge_encode(y, &parity, &p);
  out[i] = r_matches(i, y, parity, r_y, r_sign);
}

// K5: the same check in one thread a signature, with one gathered -A
// table per vote ([B][16][4][TXF_NLIMB]).
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

// points: a [B][3][TXF_NLIMB] int32 scratch the caller allocates.
int txf_verify(const uint8_t* s_nib, const uint8_t* h_nib,
               const int32_t* val_idx, const int32_t* tables,
               const int32_t* quarter_tables, int n_vals,
               const int32_t* base_quarters, const uint8_t* r_y,
               const uint8_t* r_sign, const uint8_t* pre_ok, int32_t* points,
               int32_t* out, int B, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  txf_verify_kernel<<<grid_for(B * TXF_QUARTERS, 128), 128, 0, st>>>(
      s_nib, h_nib, val_idx, tables, quarter_tables, n_vals, base_quarters,
      pre_ok, points, B);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  txf_verify_encode_kernel<<<grid_for(B, 128), 128, 0, st>>>(
      points, r_y, r_sign, pre_ok, out, B);
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
