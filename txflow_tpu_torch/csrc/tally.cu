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
// one hop of ring_tally's accumulate (txf_add, in place into the running
// total the hop owns).
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
//
// Sets of total power >= 2^30 take the int64 forms of the same three
// kernels (one template each, on the accumulator type): powers, prior and
// partials are int64, the sums are 64-bit atomics into an int64 buffer,
// and the stake segment of the packed readback holds each slot's int64 as
// two int32 words (low, high) -- S int64 in 2S words, so the segment needs
// no 8-byte alignment inside the int32 vector. The int32 forms stay for
// every smaller set. An int64 sum cannot overflow while the total power is
// below 2^62 (verifier.py enforces that bound).
//
// The served path launches neither tally kernel: the tally and the shard
// partial ride in the encode launch of txf_verify_tally (verify.cu), with
// the arithmetic of tally.cuh that these kernels share. txf_tally and
// txf_tally_partial stay as the standalone counterparts (the yardstick of
// that fused tally); the mesh's psum runs txf_reduce_quorum once a step,
// on the mesh's first card.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tally.cuh"

// prior == nullptr: start from 0; maj == nullptr: no compare (a partial);
// val_idx == nullptr: powers holds each vote's own power ([B]);
// words != nullptr: the sums in acc are copied into it by put_stake (the
// int64 form; the int32 form accumulates in the packed segment itself).
template <typename Acc>
__global__ void __launch_bounds__(1024)
txf_tally_kernel(const int32_t* __restrict__ valid,
                 const int32_t* __restrict__ slot,
                 const int32_t* __restrict__ val_idx,
                 const Acc* __restrict__ powers, int n_vals,
                 const Acc* __restrict__ prior, Acc quorum, Acc* acc,
                 int32_t* __restrict__ words, int32_t* __restrict__ maj, int B,
                 int S) {
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    acc[s] = prior ? prior[s] : Acc(0);
  __syncthreads();
  for (int i = threadIdx.x; i < B; i += blockDim.x)
    if (valid[i]) tally_add(acc, S, slot[i], powers[val_idx ? clamp_val(val_idx[i], n_vals) : i]);
  if (!maj && !words) return;
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += blockDim.x) tally_close(acc[s], s, quorum, words, maj);
}

// stake[s] = prior[s] + sum over k < n of parts[k][s]; maj[s] = stake >= quorum.
template <typename Acc>
__global__ void __launch_bounds__(256)
txf_reduce_quorum_kernel(const Acc* __restrict__ parts, int n,
                         const Acc* __restrict__ prior, Acc quorum,
                         int32_t* __restrict__ stake,
                         int32_t* __restrict__ maj, int S) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  Acc acc = prior[s];
  for (int k = 0; k < n; ++k) acc += parts[(int64_t)k * S + s];
  tally_close(acc, s, quorum, stake, maj);
}

// acc[s] += b[s]: one ring hop, in place.
__global__ void __launch_bounds__(256)
txf_add_kernel(int32_t* __restrict__ acc, const int32_t* __restrict__ b,
               int S) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s < S) acc[s] += b[s];
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
  txf_tally_kernel<int32_t><<<1, 1024, 0, (cudaStream_t)stream>>>(
      valid, slot, val_idx, powers, n_vals, prior, (int32_t)quorum, stake,
      nullptr, maj, B, S);
  return (int)cudaGetLastError();
}

// acc: an int64 [S] scratch buffer; stake_words: the packed segment [2S].
int txf_tally64(const int32_t* valid, const int32_t* slot,
                const int32_t* val_idx, const int64_t* powers, int n_vals,
                const int64_t* prior, long long quorum, int64_t* acc,
                int32_t* stake_words, int32_t* maj, int B, int S,
                void* stream) {
  if (S <= 0) return 0;
  txf_tally_kernel<int64_t><<<1, 1024, 0, (cudaStream_t)stream>>>(
      valid, slot, val_idx, powers, n_vals, prior, (int64_t)quorum, acc,
      stake_words, maj, B, S);
  return (int)cudaGetLastError();
}

int txf_tally_partial(const int32_t* valid, const int32_t* slot,
                      const int32_t* val_idx, const int32_t* powers,
                      int n_vals, int32_t* partial, int B, int S,
                      void* stream) {
  if (S <= 0) return 0;
  txf_tally_kernel<int32_t><<<1, 1024, 0, (cudaStream_t)stream>>>(
      valid, slot, val_idx, powers, n_vals, nullptr, 0, partial, nullptr,
      nullptr, B, S);
  return (int)cudaGetLastError();
}

int txf_tally_partial64(const int32_t* valid, const int32_t* slot,
                        const int32_t* val_idx, const int64_t* powers,
                        int n_vals, int64_t* partial, int B, int S,
                        void* stream) {
  if (S <= 0) return 0;
  txf_tally_kernel<int64_t><<<1, 1024, 0, (cudaStream_t)stream>>>(
      valid, slot, val_idx, powers, n_vals, nullptr, 0, partial, nullptr,
      nullptr, B, S);
  return (int)cudaGetLastError();
}

int txf_reduce_quorum(const int32_t* parts, int n, const int32_t* prior,
                      int quorum, int32_t* stake, int32_t* maj, int S,
                      void* stream) {
  if (S <= 0) return 0;
  txf_reduce_quorum_kernel<int32_t><<<grid_for(S, 256), 256, 0,
                                      (cudaStream_t)stream>>>(
      parts, n, prior, (int32_t)quorum, stake, maj, S);
  return (int)cudaGetLastError();
}

// stake_words: [2S] int32, slot s's int64 as words 2s (low) and 2s+1 (high).
int txf_reduce_quorum64(const int64_t* parts, int n, const int64_t* prior,
                        long long quorum, int32_t* stake_words, int32_t* maj,
                        int S, void* stream) {
  if (S <= 0) return 0;
  txf_reduce_quorum_kernel<int64_t><<<grid_for(S, 256), 256, 0,
                                      (cudaStream_t)stream>>>(
      parts, n, prior, (int64_t)quorum, stake_words, maj, S);
  return (int)cudaGetLastError();
}

int txf_add(int32_t* acc, const int32_t* b, int S, void* stream) {
  if (S <= 0) return 0;
  txf_add_kernel<<<grid_for(S, 256), 256, 0, (cudaStream_t)stream>>>(acc, b,
                                                                   S);
  return (int)cudaGetLastError();
}

}  // extern "C"
