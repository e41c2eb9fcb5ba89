// Batched ed25519 verification: over device-resident epoch tables (K3)
// and over per-vote gathered tables (K5), plus kernels that expose K1 (two:
// frozen field ops, raw products) and K2 alone for checking on the card.
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
// Two ways of running one signature on four lanes, both in this file:
//
// K3 (txf_verify, also K6's launch) splits the scalars: lane j of a group
// of four consecutive lanes takes quarter j of both scalars (bits [64j,
// 64j + 64), nibbles [48 - 16j, 64 - 16j) of the MSB-first nibbles), so
// [S]B + [h](-A) = sum_j [S_j] 2^(64j) B + [h_j] 2^(64j) (-A) over 16
// windows each, with the quarter-j tables of B (staged per block in shared
// memory from a device tensor) and of -A (row val_idx of the epoch's
// tables for j = 0, of its quarter tables for j = 1..3). Two butterfly
// rounds of shuffles within the group (xor 1, then xor 2) add the lanes'
// points (ge_p3_to_pniels + ge_pniels_add), lane 0 stores the sum, and a
// second launch encodes and compares it, one thread a row.
//
// K5 (txf_verify_tables) and the K2 check kernel (txf_dsm_encode) split
// each point formula instead: lane c of a group holds coordinate c of the
// Extended accumulator (X, Y, Z, T) through all 64 windows, and each
// doubling and addition runs as two rounds of four independent products,
// one a lane (the 4-way parallel form of Hisil, Wong, Carter and Dawson,
// "Twisted Edwards Curves Revisited", section 4), with whole field
// elements exchanged by shuffles between rounds. They take this split and
// not the quarter split because the quarter tables of -A are not theirs:
// K5 gets one gathered 16-entry table of -A a vote and no validator index
// (txflow_tpu/ops/ed25519_batch.py:146), so quarter tables would cost up
// to 192 serial doublings a row in the kernel or three more gathered
// tables a vote from the host; the coordinate split needs only the table
// it is given. Lanes 0-2 store X, Y and Z, and a second launch encodes,
// one thread a row (K5 through K3's encode kernel, without a tally).
//
// Built twice from this one source (ops/_lib.py:LIBS): the library verify
// over the radix-2^25.5 field (K1), and verify13 with -DTXF_FE_RADIX=13
// over the radix-2^13 field (K8, fe25519_13.cuh; tables [V, 16, 4, 20]).
// Both splits are at the point level, so both fields take them from this
// source. No kernel reads __constant__ memory: every base table is a
// device tensor (curve.device_base_quarters) staged in shared memory per
// block, since a warp's lanes read up to 32 different entries at once,
// which the constant cache would serve one address at a time.
//
// What bounds it: integer multiply-adds (3147 field products a signature
// in one thread, about 362k 32-bit multiply-adds over the radix-2^25.5
// field, 1.34M over radix 2^13; the quarter split does 3103, see
// ops/curve.py:MULS_PER_QUARTER_DSM_ENCODE; the coordinate split issues
// 3339, MULS_PER_COORD_DSM_ENCODE); the inputs are 162 bytes per vote
// plus the epoch tables (L1/L2-resident for any realistic validator set)
// -- or, for K5, 2560 or 5120 bytes of gathered table per vote, still two
// orders of magnitude under the multiply-add time. But no batch the
// engine sends keeps the card's multiply-add units busy when one thread
// carries a signature: its chain of 3147 dependent products is the
// kernel's time at 8 rows (one warp) and still at 16,384 (512 warps on
// 132 SMs, about one warp a scheduler, 188 registers a thread: nothing to
// issue while a product's latency runs). Both splits answer with four
// times the warps and a lane's chain cut to about a third: the quarter
// split to about 976 products (16 windows of 45 less the first window's
// 29 doublings of the identity, two combine rounds of 9, then the
// encode's 267 in the second launch), the coordinate split to 1035 (64
// windows of 12: each formula's two rounds; then the encode's 267). What
// neither does is split one field product over lanes: its 100 (or 400)
// multiply-adds feed one carry chain, so the partial column sums would
// cross lanes inside every product, where the coordinate split exchanges
// whole field elements only between a formula's two rounds. The encode
// runs one thread a row so that a warp pays its serial chain for 32 rows,
// not 8. All curve state stays in registers, and rows whose host
// pre-checks failed (bucket padding, S >= L, off-curve keys, in-batch
// repeats) return at once, a whole group together, instead of computing a
// result that the AND would discard.
//
// The served step (txf_verify_tally, txf_verify_tally64) carries the
// stake tally in the same two launches: K4 on one card, or a shard's
// partial (K7) on a mesh. Replaces, beside K3: txflow_tpu/ops/tally.py
// :compact_step_packed's tally (power gather, segment-sum, prior, the
// quorum compare). The tally is launch-bound, not work-bound (one block's
// few microseconds of latency and a launch for about 12 bytes a vote;
// tally.cu), so it gets no launch of its own: the first launch also seeds
// the accumulator (prior stake, or 0 for a partial) and zeroes the
// call's completion counter; each thread of the encode launch adds its
// row's power into its slot by an integer atomic when the row is valid;
// and the block that finishes last (a __threadfence, then one atomic on
// the counter a block) compares every slot with the quorum and writes
// the packed stake and maj23 segments. Stream order puts the seed before
// every add. The counter is the call's own scratch, never a __device__
// global: two steps in flight, or the priority and bulk lanes, launch on
// one card. The arithmetic is tally.cuh's, shared with tally.cu.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ge25519.cuh"
#include "tally.cuh"

#define TXF_ROW (4 * TXF_NLIMB)  // int32 per PNiels table entry
#define TXF_QUARTERS 4
#define TXF_QWINDOWS 16  // windows a lane runs: 64 bits of each scalar
#define TXF_CLOSE_LOADS 16  // slots a thread of the closing block reads at once
#define TXF_COORDS 4  // lanes a row of the coordinate split (K5, K2)

// encode(P) against the signature's raw R: y limbs and the sign bit.
__device__ __forceinline__ int32_t r_matches(int i, const fe y, int32_t parity,
                                             const uint8_t* __restrict__ r_y,
                                             const uint8_t* __restrict__ r_sign) {
  fe r;
  fe_from_bytes(r, r_y + (int64_t)i * 32);
  return (fe_equal(y, r) && parity == (int32_t)r_sign[i]) ? 1 : 0;
}

// P = (X, Y, Z) of row i from a [B][3][TXF_NLIMB] points scratch (T is
// not stored: the encode does not read it).
__device__ __forceinline__ void ge_load_xyz(ge_p3* p, const int32_t* __restrict__ points,
                                            int i) {
  const int32_t* o = points + (int64_t)i * 3 * TXF_NLIMB;
#pragma unroll
  for (int l = 0; l < TXF_NLIMB; ++l) {
    p->X[l] = o[l];
    p->Y[l] = o[TXF_NLIMB + l];
    p->Z[l] = o[2 * TXF_NLIMB + l];
  }
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
// pre-checks failed writes nothing. With seed != nullptr (the fused
// tally) the grid first copies seed_words int32 words of seed_from into
// seed (the accumulator; seed_from nullptr: zeros) and zeroes *done.
__global__ void __launch_bounds__(128)
txf_verify_kernel(const uint8_t* __restrict__ s_nib,
                  const uint8_t* __restrict__ h_nib,
                  const int32_t* __restrict__ val_idx,
                  const int32_t* __restrict__ tables,
                  const int32_t* __restrict__ quarter_tables, int n_vals,
                  const int32_t* __restrict__ base_quarters,
                  const uint8_t* __restrict__ pre_ok,
                  int32_t* __restrict__ points, int B,
                  int32_t* __restrict__ seed,
                  const int32_t* __restrict__ seed_from, int seed_words,
                  unsigned* __restrict__ done) {
  __shared__ int32_t s_base[TXF_QUARTERS * 16 * TXF_ROW];
  for (int k = threadIdx.x; k < TXF_QUARTERS * 16 * TXF_ROW; k += blockDim.x)
    s_base[k] = base_quarters[k];
  if (seed) {
    const int stride = gridDim.x * blockDim.x;
    for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < seed_words; k += stride)
      seed[k] = seed_from ? seed_from[k] : 0;
  }
  if (done && blockIdx.x == 0 && threadIdx.x == 0) *done = 0;
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
//
// With slot != nullptr it carries the tally as its epilogue: a valid
// row's thread adds powers[clamp(val_idx)] into acc[slot] (slots outside
// [0, S) add nothing). With done != nullptr the block that finishes last
// then closes every slot of acc (tally_close: the stake words when words
// != nullptr, maj23 when maj != nullptr) and leaves *done at 0. No thread
// returns before the completion step.
template <typename Acc>
__global__ void __launch_bounds__(128)
txf_verify_encode_kernel(const int32_t* __restrict__ points,
                         const uint8_t* __restrict__ r_y,
                         const uint8_t* __restrict__ r_sign,
                         const uint8_t* __restrict__ pre_ok,
                         int32_t* __restrict__ out, int B,
                         const int32_t* __restrict__ slot,
                         const int32_t* __restrict__ val_idx,
                         const Acc* __restrict__ powers, int n_vals, Acc* acc,
                         Acc quorum, int32_t* __restrict__ words,
                         int32_t* __restrict__ maj, unsigned* done, int S) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int32_t ok = 0;
  if (i < B && pre_ok[i]) {
    ge_p3 p;
    ge_load_xyz(&p, points, i);
    fe y;
    int32_t parity;
    ge_encode(y, &parity, &p);
    ok = r_matches(i, y, parity, r_y, r_sign);
  }
  if (i < B) {
    out[i] = ok;
    if (slot && ok) tally_add(acc, S, slot[i], powers[clamp_val(val_idx[i], n_vals)]);
  }
  if (!done) return;  // the same for every thread of the grid
  // last block done: every block's adds are visible before its count
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // The close is the launch's serial tail, one block over all S slots:
  // each thread reads its next TXF_CLOSE_LOADS slots from L2 (past L1:
  // the adds went there) before it writes any, so that many round trips
  // overlap instead of one a slot.
  for (int s0 = threadIdx.x; s0 < S; s0 += TXF_CLOSE_LOADS * blockDim.x) {
    Acc v[TXF_CLOSE_LOADS];
#pragma unroll
    for (int k = 0; k < TXF_CLOSE_LOADS; ++k) {
      const int s = s0 + k * blockDim.x;
      v[k] = s < S ? load_l2(acc + s) : Acc(0);
    }
#pragma unroll
    for (int k = 0; k < TXF_CLOSE_LOADS; ++k) {
      const int s = s0 + k * blockDim.x;
      if (s < S) tally_close(v[k], s, quorum, words, maj);
    }
  }
  if (threadIdx.x == 0) *done = 0;
}

// Lane src's field element within the group of four (any src a lane
// names, itself included).
__device__ __forceinline__ void fe_shfl(fe out, const fe v, int src, unsigned mask) {
#pragma unroll
  for (int l = 0; l < TXF_NLIMB; ++l) out[l] = __shfl_sync(mask, v[l], src, TXF_COORDS);
}

// K5 and K2, first launch: the coordinate split. Four consecutive lanes a
// row, lane c holding coordinate c of the Extended accumulator (X, Y, Z,
// T); blockDim / 4 rows a block; 64 windows MSB first, each 4 doublings,
// + [s_w]B, + [h_w]A'. A formula is two rounds, one field product a lane
// in each:
//   doubling round 1 (one shuffle: lane 0 takes Y, lane 3 takes X):
//     lane 0 (X+Y)^2, lane 1 Y^2, lane 2 2 Z^2, lane 3 X^2, each by fe_sq
//     (a doubling is the same on every lane of a warp: no divergence);
//   addition round 1 (one xor-1 shuffle: lane 0 takes Y, 1 X, 2 T, 3 Z;
//     lane c loads coordinate c^1 of the PNiels entry, so a group reads
//     one contiguous row): lane 0 A = (Y-X)(Y2-X2), lane 1 B =
//     (Y+X)(Y2+X2), lane 2 C = T 2dT2, lane 3 D = 2 Z Z2;
//   round 2 of both (every lane reads the four products, four shuffles,
//     and forms E, F, G, H as ge_double or ge_pniels_add does): lane 0
//     X3 = E F, lane 1 Y3 = G H, lane 2 Z3 = F G, lane 3 T3 = E H; in a
//     doubling lane 3 keeps its T unless an addition follows (compute_t).
// These are the field operations of ge_double and ge_pniels_add on the
// same operands, so ge25519.cuh's bounds hold as they are, and after
// every window the four lanes hold the one-lane accumulator limb for limb
// (the plain version, ops/curve.py:_windowed_lanes, checks this against
// _windowed). Divergence is confined to the adds and copies that pick a
// lane's operands; every product and shuffle runs on all four lanes.
//
// Row i's A' table is tables + (val_idx ? clamp(val_idx[i]) : i) * 16
// entries: K2's epoch tables [V][16][TXF_ROW] by validator, or K5's one
// gathered table a row [B][16][TXF_ROW]. base [16][TXF_ROW] (quarter 0 of
// the base quarters) is staged in shared memory. Lanes 0-2 write X, Y, Z
// into points [B][3][TXF_NLIMB]; a row whose pre_ok is false (pre_ok
// nullptr: every row is computed) returns at once, its whole group.
__global__ void __launch_bounds__(128)
txf_coord_dsm_kernel(const uint8_t* __restrict__ s_nib,
                     const uint8_t* __restrict__ h_nib,
                     const int32_t* __restrict__ val_idx,
                     const int32_t* __restrict__ tables, int n_vals,
                     const int32_t* __restrict__ base,
                     const uint8_t* __restrict__ pre_ok,
                     int32_t* __restrict__ points, int B) {
  __shared__ int32_t s_base[16 * TXF_ROW];
  for (int k = threadIdx.x; k < 16 * TXF_ROW; k += blockDim.x) s_base[k] = base[k];
  __syncthreads();
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = t >> 2;
  const int c = t & 3;
  // a group's four lanes share i: they leave together, and every shuffle
  // below names only the group's lanes
  if (i >= B || (pre_ok && !pre_ok[i])) return;
  const int32_t* vt =
      tables + (int64_t)(val_idx ? clamp_val(val_idx[i], n_vals) : i) * 16 * TXF_ROW;
  const uint8_t* sn = s_nib + (int64_t)i * 64;
  const uint8_t* hn = h_nib + (int64_t)i * 64;
  const unsigned mask = 0xFu << (threadIdx.x & 28);
  fe p;  // coordinate c of the accumulator, the identity (0, 1, 1, 0) first
  fe_set_small(p, c == 1 || c == 2);
#pragma unroll 1
  for (int w = 0; w < 64; ++w) {
#pragma unroll 1
    for (int k = 0; k < 6; ++k) {  // 4 doublings, + [s_w]B, + [h_w]A'
      const bool dbl = k < 4;
      // round 1: one product a lane
      fe r, a, b, q;
      fe_shfl(r, p, dbl ? (c == 0 ? 1 : (c == 3 ? 0 : c)) : (c ^ 1), mask);
      if (dbl) {  // a square on every lane
        if (c == 0)
          fe_add(a, p, r);  // X + Y
        else if (c == 3)
          fe_copy(a, r);  // X
        else
          fe_copy(a, p);  // Y, Z
        fe_sq(q, a);
      } else {
        if (c == 0)
          fe_sub(a, r, p);  // Y - X
        else if (c == 1)
          fe_add(a, p, r);  // Y + X
        else
          fe_copy(a, r);  // lane 2: T, lane 3: Z
        const int e = (c ^ 1) * TXF_NLIMB;
        if (k == 4) {
          const int32_t* row = s_base + (sn[w] & 15) * TXF_ROW + e;
#pragma unroll
          for (int l = 0; l < TXF_NLIMB; ++l) b[l] = row[l];
        } else {
          const int32_t* row = vt + (hn[w] & 15) * TXF_ROW + e;
#pragma unroll
          for (int l = 0; l < TXF_NLIMB; ++l) b[l] = row[l];
        }
        fe_mul(q, a, b);
      }
      if (c == (dbl ? 2 : 3)) fe_mul_small(q, q, 2);  // C = 2 Z^2, D = 2 Z Z2
      // round 2: the four products on every lane
      fe q0, q1, q2, q3, E, F, G, H;
      fe_shfl(q0, q, 0, mask);
      fe_shfl(q1, q, 1, mask);
      fe_shfl(q2, q, 2, mask);
      fe_shfl(q3, q, 3, mask);
      if (dbl) {  // q0 (X+Y)^2, q1 B = Y^2, q2 C = 2 Z^2, q3 A = X^2
        fe_add(H, q3, q1);
        fe_sub(E, H, q0);
        fe_sub(G, q3, q1);
        fe_add(F, q2, G);
      } else {  // q0 A, q1 B, q2 C, q3 D
        fe_sub(E, q1, q0);
        fe_sub(F, q3, q2);
        fe_add(G, q3, q2);
        fe_add(H, q1, q0);
      }
      fe x, y;
#pragma unroll
      for (int l = 0; l < TXF_NLIMB; ++l) {
        x[l] = c == 1 ? G[l] : (c == 2 ? F[l] : E[l]);
        y[l] = c == 0 ? F[l] : (c == 2 ? G[l] : H[l]);
      }
      fe_mul(x, x, y);
      if (c != 3 || k >= 3) fe_copy(p, x);
    }
  }
  if (c < 3) {
    int32_t* o = points + ((int64_t)i * 3 + c) * TXF_NLIMB;
#pragma unroll
    for (int l = 0; l < TXF_NLIMB; ++l) o[l] = p[l];
  }
}

// K2, second launch: one thread a row encodes P into y and its parity.
__global__ void __launch_bounds__(128)
txf_dsm_encode_kernel(const int32_t* __restrict__ points,
                      int32_t* __restrict__ y_out,
                      int32_t* __restrict__ parity_out, int B) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  ge_p3 p;
  ge_load_xyz(&p, points, i);
  fe y;
  int32_t parity;
  ge_encode(y, &parity, &p);
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

// Per element: the raw carried limbs (not frozen) of mul(a, b), sq(a) and
// mul_small(a, 2), written as out[i][3][TXF_NLIMB]: the three products
// every verify kernel chains, checked limb for limb on inputs up to the
// field's input bound (K1's check on the bound edges).
__global__ void txf_fe_prod_kernel(const int32_t* __restrict__ a,
                                   const int32_t* __restrict__ b,
                                   int32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fe fa, fb, t;
#pragma unroll
  for (int l = 0; l < TXF_NLIMB; ++l) {
    fa[l] = a[(int64_t)i * TXF_NLIMB + l];
    fb[l] = b[(int64_t)i * TXF_NLIMB + l];
  }
  int32_t* o = out + (int64_t)i * 3 * TXF_NLIMB;
  fe_mul(t, fa, fb);
#pragma unroll
  for (int l = 0; l < TXF_NLIMB; ++l) o[l] = t[l];
  fe_sq(t, fa);
#pragma unroll
  for (int l = 0; l < TXF_NLIMB; ++l) o[TXF_NLIMB + l] = t[l];
  fe_mul_small(t, fa, 2);
#pragma unroll
  for (int l = 0; l < TXF_NLIMB; ++l) o[2 * TXF_NLIMB + l] = t[l];
}

static inline int grid_for(int n, int threads) {
  return (n + threads - 1) / threads;
}

// txf_verify's two launches, the second carrying the tally when slot !=
// nullptr (see txf_verify_encode_kernel); the first seeds acc (S values
// of Acc) from prior (nullptr: 0) and zeroes *done when there is a tally.
// At least one block each, so that a call of no rows still writes the
// tally of its prior.
template <typename Acc>
static int verify_launches(const uint8_t* s_nib, const uint8_t* h_nib,
                           const int32_t* val_idx, const int32_t* tables,
                           const int32_t* quarter_tables, int n_vals,
                           const int32_t* base_quarters, const uint8_t* r_y,
                           const uint8_t* r_sign, const uint8_t* pre_ok,
                           int32_t* points, int32_t* out, const int32_t* slot,
                           const Acc* powers, const Acc* prior, Acc quorum,
                           Acc* acc, int32_t* words, int32_t* maj,
                           unsigned* done, int B, int S, cudaStream_t st) {
  const int grid1 = B > 0 ? grid_for(B * TXF_QUARTERS, 128) : 1;
  const int seed_words = slot ? S * (int)(sizeof(Acc) / sizeof(int32_t)) : 0;
  txf_verify_kernel<<<grid1, 128, 0, st>>>(
      s_nib, h_nib, val_idx, tables, quarter_tables, n_vals, base_quarters,
      pre_ok, points, B, slot ? reinterpret_cast<int32_t*>(acc) : nullptr,
      reinterpret_cast<const int32_t*>(prior), seed_words, done);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  txf_verify_encode_kernel<Acc><<<B > 0 ? grid_for(B, 128) : 1, 128, 0, st>>>(
      points, r_y, r_sign, pre_ok, out, B, slot, val_idx, powers, n_vals, acc,
      quorum, words, maj, done, S);
  return (int)cudaGetLastError();
}

extern "C" {

// points: a [B][3][TXF_NLIMB] int32 scratch the caller allocates.
int txf_verify(const uint8_t* s_nib, const uint8_t* h_nib,
               const int32_t* val_idx, const int32_t* tables,
               const int32_t* quarter_tables, int n_vals,
               const int32_t* base_quarters, const uint8_t* r_y,
               const uint8_t* r_sign, const uint8_t* pre_ok, int32_t* points,
               int32_t* out, int B, void* stream) {
  if (B <= 0) return 0;
  return verify_launches<int32_t>(
      s_nib, h_nib, val_idx, tables, quarter_tables, n_vals, base_quarters,
      r_y, r_sign, pre_ok, points, out, nullptr, nullptr, nullptr, 0, nullptr,
      nullptr, nullptr, nullptr, B, 0, (cudaStream_t)stream);
}

// The fused step: verify and tally in two launches. With prior and maj
// (and done, a zeroed-by-launch-1 unsigned of the call's scratch) the
// quorum form: acc is the packed stake segment [S], maj the maj23
// segment. With prior, maj and done all nullptr the partial form of a
// shard: acc [S] ends holding the shard's partial stake.
int txf_verify_tally(const uint8_t* s_nib, const uint8_t* h_nib,
                     const int32_t* val_idx, const int32_t* tables,
                     const int32_t* quarter_tables, int n_vals,
                     const int32_t* base_quarters, const uint8_t* r_y,
                     const uint8_t* r_sign, const uint8_t* pre_ok,
                     int32_t* points, int32_t* out, const int32_t* slot,
                     const int32_t* powers, const int32_t* prior, int quorum,
                     int32_t* acc, int32_t* maj, unsigned* done, int B, int S,
                     void* stream) {
  return verify_launches<int32_t>(
      s_nib, h_nib, val_idx, tables, quarter_tables, n_vals, base_quarters,
      r_y, r_sign, pre_ok, points, out, slot, powers, prior, (int32_t)quorum,
      acc, nullptr, maj, done, B, S, (cudaStream_t)stream);
}

// The int64 form: acc an int64 [S] (the call's scratch in the quorum
// form, whose last block writes each sum into words, the packed stake
// segment of 2S int32 words; the shard's int64 partial in the partial
// form, words nullptr).
int txf_verify_tally64(const uint8_t* s_nib, const uint8_t* h_nib,
                       const int32_t* val_idx, const int32_t* tables,
                       const int32_t* quarter_tables, int n_vals,
                       const int32_t* base_quarters, const uint8_t* r_y,
                       const uint8_t* r_sign, const uint8_t* pre_ok,
                       int32_t* points, int32_t* out, const int32_t* slot,
                       const int64_t* powers, const int64_t* prior,
                       long long quorum, int64_t* acc, int32_t* words,
                       int32_t* maj, unsigned* done, int B, int S,
                       void* stream) {
  return verify_launches<int64_t>(
      s_nib, h_nib, val_idx, tables, quarter_tables, n_vals, base_quarters,
      r_y, r_sign, pre_ok, points, out, slot, powers, prior, (int64_t)quorum,
      acc, words, maj, done, B, S, (cudaStream_t)stream);
}

// K5: four lanes a row, then K3's encode launch without a tally. base:
// the base table [16][TXF_ROW]; points: a [B][3][TXF_NLIMB] int32 scratch
// the caller allocates.
int txf_verify_tables(const uint8_t* s_nib, const uint8_t* h_nib,
                      const int32_t* a_tables, const int32_t* base,
                      const uint8_t* r_y, const uint8_t* r_sign,
                      const uint8_t* pre_ok, int32_t* points, int32_t* out, int B,
                      void* stream) {
  if (B <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  txf_coord_dsm_kernel<<<grid_for(B * TXF_COORDS, 128), 128, 0, st>>>(
      s_nib, h_nib, nullptr, a_tables, B, base, pre_ok, points, B);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  txf_verify_encode_kernel<int32_t><<<grid_for(B, 128), 128, 0, st>>>(
      points, r_y, r_sign, pre_ok, out, B, nullptr, nullptr, nullptr, 0, nullptr,
      0, nullptr, nullptr, nullptr, 0);
  return (int)cudaGetLastError();
}

// The K2 check: every row computed, its y and parity written. base and
// points as for txf_verify_tables.
int txf_dsm_encode(const uint8_t* s_nib, const uint8_t* h_nib,
                   const int32_t* val_idx, const int32_t* tables, int n_vals,
                   const int32_t* base, int32_t* points, int32_t* y_out,
                   int32_t* parity_out, int B, void* stream) {
  if (B <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  txf_coord_dsm_kernel<<<grid_for(B * TXF_COORDS, 128), 128, 0, st>>>(
      s_nib, h_nib, val_idx, tables, n_vals, base, nullptr, points, B);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  txf_dsm_encode_kernel<<<grid_for(B, 128), 128, 0, st>>>(points, y_out, parity_out, B);
  return (int)cudaGetLastError();
}

int txf_fe_ops(const int32_t* a, const int32_t* b, int32_t* out, int n,
               void* stream) {
  if (n <= 0) return 0;
  txf_fe_ops_kernel<<<grid_for(n, 128), 128, 0, (cudaStream_t)stream>>>(
      a, b, out, n);
  return (int)cudaGetLastError();
}

int txf_fe_prod(const int32_t* a, const int32_t* b, int32_t* out, int n,
                void* stream) {
  if (n <= 0) return 0;
  txf_fe_prod_kernel<<<grid_for(n, 128), 128, 0, (cudaStream_t)stream>>>(
      a, b, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
