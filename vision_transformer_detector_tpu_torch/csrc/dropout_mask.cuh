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

// The seed, the keep threshold (keep iff hash < threshold, as the Pallas
// module's `_keep_threshold`) and 1 / (1 - rate) in fp32.
struct Dropout {
  unsigned int seed, threshold;
  float inv_keep;
};

// The hash's sum seed + bh * 0x9E3779B1 + query * 0x85EBCA6B + key *
// 0xC2B2AE35 (mod 2^32), split so that a thread adds the term of the
// index it loops over to a part it computes once.
__device__ __forceinline__ unsigned int hash_part(const Dropout& d,
                                                  unsigned int bh) {
  return d.seed + bh * 0x9E3779B1u;
}

__device__ __forceinline__ unsigned int query_term(unsigned int query) {
  return query * 0x85EBCA6Bu;
}

__device__ __forceinline__ unsigned int key_term(unsigned int key) {
  return key * 0xC2B2AE35u;
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
