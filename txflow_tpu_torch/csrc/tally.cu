// Stake tally of one verified batch (K4), and the pieces of the sharded
// tally over a mesh of cards (K7).
//
// Replaces: txflow_tpu/ops/tally.py:tally_kernel and the tail of
// compact_step / compact_step_packed (power gather by validator index,
// segment-sum over tx slots, prior stake, the >= quorum compare), writing
// the stake and maj23 segments of the packed [valid | stake | maj23]
// int32 readback in place; and, for parallel/mesh.py (K7), the per-shard
// partial tally (the same kernel with no prior and no compare), the psum
// of the partials with the prior and the compare (txf_reduce_quorum), and
// one hop of ring_tally's accumulate (txf_add).
//
// What bounds them: neither bytes (about 12 bytes a vote and 12 a slot)
// nor operations: at the engine's sizes each is a few microseconds of
// launch and barrier latency. Design answer for the tally: one block of
// 1024 threads and three phases split by __syncthreads() -- seed the slots
// with prior stake (or 0), atomicAdd each valid vote's power into its
// slot, then compare with the quorum -- so one launch does the whole tally
// with no second pass. Integer atomics commute, so the sums are exact and
// independent of the order in which threads run. The reduction and the
// hop are elementwise over the slots: one thread a slot, each summing the
// n partials in shard order (exact in int32: the partials of one batch sum
// to at most the total power, below 2^30).
#include <cuda_runtime.h>
#include <stdint.h>

// prior == nullptr: start from 0; maj == nullptr: no compare (a partial);
// val_idx == nullptr: powers holds each vote's own power ([B]).
__global__ void __launch_bounds__(1024)
txf_tally_kernel(const int32_t* __restrict__ valid,
                 const int32_t* __restrict__ slot,
                 const int32_t* __restrict__ val_idx,
                 const int32_t* __restrict__ powers, int n_vals,
                 const int32_t* __restrict__ prior, int32_t quorum,
                 int32_t* stake, int32_t* __restrict__ maj, int B, int S) {
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    stake[s] = prior ? prior[s] : 0;
  __syncthreads();
  for (int i = threadIdx.x; i < B; i += blockDim.x) {
    const int32_t sl = slot[i];
    if (valid[i] && sl >= 0 && sl < S) {
      int32_t v = i;
      if (val_idx) {
        v = val_idx[i];
        v = v < 0 ? 0 : (v >= n_vals ? n_vals - 1 : v);
      }
      atomicAdd(&stake[sl], powers[v]);
    }
  }
  if (!maj) return;
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    maj[s] = stake[s] >= quorum ? 1 : 0;
}

// stake[s] = prior[s] + sum over k < n of parts[k][s]; maj[s] = stake >= quorum.
__global__ void __launch_bounds__(256)
txf_reduce_quorum_kernel(const int32_t* __restrict__ parts, int n,
                         const int32_t* __restrict__ prior, int32_t quorum,
                         int32_t* __restrict__ stake,
                         int32_t* __restrict__ maj, int S) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  int32_t acc = prior[s];
  for (int k = 0; k < n; ++k) acc += parts[(int64_t)k * S + s];
  stake[s] = acc;
  maj[s] = acc >= quorum ? 1 : 0;
}

__global__ void __launch_bounds__(256)
txf_add_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
               int32_t* __restrict__ out, int S) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s < S) out[s] = a[s] + b[s];
}

static inline int grid_for(int n, int threads) {
  return (n + threads - 1) / threads;
}

extern "C" {

int txf_tally(const int32_t* valid, const int32_t* slot,
              const int32_t* val_idx, const int32_t* powers, int n_vals,
              const int32_t* prior, int quorum, int32_t* stake, int32_t* maj,
              int B, int S, void* stream) {
  if (S <= 0) return 0;
  txf_tally_kernel<<<1, 1024, 0, (cudaStream_t)stream>>>(
      valid, slot, val_idx, powers, n_vals, prior, (int32_t)quorum, stake,
      maj, B, S);
  return (int)cudaGetLastError();
}

int txf_tally_partial(const int32_t* valid, const int32_t* slot,
                      const int32_t* val_idx, const int32_t* powers,
                      int n_vals, int32_t* partial, int B, int S,
                      void* stream) {
  if (S <= 0) return 0;
  txf_tally_kernel<<<1, 1024, 0, (cudaStream_t)stream>>>(
      valid, slot, val_idx, powers, n_vals, nullptr, 0, partial, nullptr, B,
      S);
  return (int)cudaGetLastError();
}

int txf_reduce_quorum(const int32_t* parts, int n, const int32_t* prior,
                      int quorum, int32_t* stake, int32_t* maj, int S,
                      void* stream) {
  if (S <= 0) return 0;
  txf_reduce_quorum_kernel<<<grid_for(S, 256), 256, 0,
                             (cudaStream_t)stream>>>(
      parts, n, prior, (int32_t)quorum, stake, maj, S);
  return (int)cudaGetLastError();
}

int txf_add(const int32_t* a, const int32_t* b, int32_t* out, int S,
            void* stream) {
  if (S <= 0) return 0;
  txf_add_kernel<<<grid_for(S, 256), 256, 0, (cudaStream_t)stream>>>(a, b,
                                                                   out, S);
  return (int)cudaGetLastError();
}

}  // extern "C"
