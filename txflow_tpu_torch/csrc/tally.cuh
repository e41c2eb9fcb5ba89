// The stake tally's arithmetic, shared by the standalone tally kernels
// (tally.cu: K4, K7) and the tally that txf_verify_tally carries in its
// encode launch (verify.cu): one copy of the clamp of a validator index,
// the accumulate into a slot, the packed stake segment's layout and the
// quorum compare, for both accumulator widths.
//
// Replaces: the tail of txflow_tpu/ops/tally.py:compact_step (the power
// gather, tally_kernel's segment-sum, prior + stake >= quorum).
#pragma once

#include <stdint.h>

// A validator index clamped into [0, n_vals): a padding row's index may
// be anything, and its power is read but never added (it is not valid).
__device__ __forceinline__ int clamp_val(int32_t v, int n_vals) {
  return v < 0 ? 0 : (v >= n_vals ? n_vals - 1 : v);
}

__device__ __forceinline__ void acc_add(int32_t* p, int32_t v) { atomicAdd(p, v); }

__device__ __forceinline__ void acc_add(int64_t* p, int64_t v) {
  // two's complement: the unsigned 64-bit add is the signed one
  atomicAdd(reinterpret_cast<unsigned long long*>(p), static_cast<unsigned long long>(v));
}

// One valid vote's power into its slot; a slot outside [0, S) (padding,
// or no slot) adds nothing.
template <typename Acc>
__device__ __forceinline__ void tally_add(Acc* acc, int S, int32_t slot, Acc power) {
  if (slot >= 0 && slot < S) acc_add(&acc[slot], power);
}

// A slot's sum as another block's atomics left it: read from L2 (ld.cg),
// past this SM's L1.
__device__ __forceinline__ int32_t load_l2(const int32_t* p) { return __ldcg(p); }

__device__ __forceinline__ int64_t load_l2(const int64_t* p) {
  return static_cast<int64_t>(__ldcg(reinterpret_cast<const long long*>(p)));
}

// Slot s's stake into the packed segment: one int32, or an int64 as two
// int32 words (low, high).
__device__ __forceinline__ void put_stake(int32_t* out, int s, int32_t v) { out[s] = v; }

__device__ __forceinline__ void put_stake(int32_t* out, int s, int64_t v) {
  const uint64_t u = static_cast<uint64_t>(v);
  out[2 * s] = static_cast<int32_t>(static_cast<uint32_t>(u));
  out[2 * s + 1] = static_cast<int32_t>(static_cast<uint32_t>(u >> 32));
}

// Slot s's finished sum: its stake words (words != nullptr: the int64
// form, whose sums live in a scratch buffer) and its maj23 flag
// (maj != nullptr).
template <typename Acc>
__device__ __forceinline__ void tally_close(Acc v, int s, Acc quorum, int32_t* words,
                                            int32_t* maj) {
  if (words) put_stake(words, s, v);
  if (maj) maj[s] = v >= quorum ? 1 : 0;
}
