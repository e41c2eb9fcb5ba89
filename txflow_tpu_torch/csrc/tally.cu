// Stake tally of one verified batch (K4).
//
// Replaces: txflow_tpu/ops/tally.py:tally_kernel and the tail of
// compact_step / compact_step_packed (power gather by validator index,
// segment-sum over tx slots, prior stake, the >= quorum compare), writing
// the stake and maj23 segments of the packed [valid | stake | maj23]
// int32 readback in place.
//
// What bounds it: neither bytes (about 12 bytes a vote and 12 a slot)
// nor operations: at the engine's sizes it is a few microseconds of
// launch and barrier latency. Design answer: one block of 1024 threads
// and three phases split by __syncthreads() -- seed the slots with prior
// stake, atomicAdd each valid vote's power into its slot, then compare
// with the quorum -- so one launch does the whole tally with no second
// pass. Integer atomics commute, so the sums are exact and independent
// of the order in which threads run.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void __launch_bounds__(1024)
txf_tally_kernel(const int32_t* __restrict__ valid,
                 const int32_t* __restrict__ slot,
                 const int32_t* __restrict__ val_idx,
                 const int32_t* __restrict__ powers, int n_vals,
                 const int32_t* __restrict__ prior, int32_t quorum,
                 int32_t* stake, int32_t* __restrict__ maj, int B, int S) {
  for (int s = threadIdx.x; s < S; s += blockDim.x) stake[s] = prior[s];
  __syncthreads();
  for (int i = threadIdx.x; i < B; i += blockDim.x) {
    const int32_t sl = slot[i];
    if (valid[i] && sl >= 0 && sl < S) {
      int32_t v = val_idx[i];
      v = v < 0 ? 0 : (v >= n_vals ? n_vals - 1 : v);
      atomicAdd(&stake[sl], powers[v]);
    }
  }
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    maj[s] = stake[s] >= quorum ? 1 : 0;
}

extern "C" int txf_tally(const int32_t* valid, const int32_t* slot,
                         const int32_t* val_idx, const int32_t* powers,
                         int n_vals, const int32_t* prior, int quorum,
                         int32_t* stake, int32_t* maj, int B, int S,
                         void* stream) {
  if (S <= 0) return 0;
  txf_tally_kernel<<<1, 1024, 0, (cudaStream_t)stream>>>(
      valid, slot, val_idx, powers, n_vals, prior, (int32_t)quorum, stake,
      maj, B, S);
  return (int)cudaGetLastError();
}
