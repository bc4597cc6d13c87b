// The attention dropout mask shared by flash_attention_fwd.cu and
// flash_attention_bwd.cu: `dropout_keep_mask` of
// vision_transformer_detector_tpu/kernels/flash_attention.py, a murmur3
// finalizer over uint32 of the seed and the global (batch*head, query,
// key) indices, kept iff below a threshold. CUDA's unsigned int arithmetic
// (wrapping multiplies, logical shifts) is the JAX uint32 arithmetic, so
// the masks are bit-equal to the JAX package's, and the backward kernel
// regenerates the forward's mask from the same indices.

#pragma once

namespace {

// The seed's address in device memory (a uint32 the caller writes before
// the launch, so a captured CUDA graph replays each step with that step's
// seed), the keep threshold (keep iff hash < threshold, as the Pallas
// module's `_keep_threshold`), 1 / (1 - rate) in fp32, and the global
// coordinates of the launch's first batch*head row, query and key: a
// launch over a shard of the batch (data parallelism) or of the tokens (a
// ring attention block) adds them to its local indices, so it draws the
// mask the whole array would have drawn there (JAX's ring keys its mask
// the same way). All 0 for a launch over the whole array.
struct Dropout {
  const unsigned int* seed;
  unsigned int threshold;
  float inv_keep;
  unsigned int bh_base;
  unsigned int q_base;
  unsigned int k_base;
};

// The seed, read from device memory once by each thread at the start of
// its block's work.
__device__ __forceinline__ unsigned int load_seed(const Dropout& d) {
  return __ldg(d.seed);
}

// The hash's sum seed + bh * 0x9E3779B1 + query * 0x85EBCA6B + key *
// 0xC2B2AE35 (mod 2^32) over the global indices (local index + base),
// split so that a thread adds the term of the index it loops over to a
// part it computes once.
__device__ __forceinline__ unsigned int hash_part(const Dropout& d,
                                                  unsigned int seed,
                                                  unsigned int bh) {
  return seed + (d.bh_base + bh) * 0x9E3779B1u;
}

__device__ __forceinline__ unsigned int query_term(const Dropout& d,
                                                   unsigned int query) {
  return (d.q_base + query) * 0x85EBCA6Bu;
}

__device__ __forceinline__ unsigned int key_term(const Dropout& d,
                                                 unsigned int key) {
  return (d.k_base + key) * 0xC2B2AE35u;
}

// The finalizer of `dropout_keep_mask` on the full sum.
__device__ __forceinline__ bool keep(const Dropout& d, unsigned int sum) {
  unsigned int x = sum;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x < d.threshold;
}

}  // namespace
