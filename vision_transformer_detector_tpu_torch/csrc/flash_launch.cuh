// The launch arguments of the flash-attention C entry points, shared by the
// six flash sources (flash_attention_fwd.cu, flash_attention_fwd_sm90.cu,
// flash_attention_fwd_wide.cu, flash_attention_bwd.cu,
// flash_attention_bwd_wide.cu, flash_attention_bwd_sm90.cu).
//
// An entry point takes the call's device addresses and stream as arguments
// and everything else as one block, FlashFwdArgs or FlashBwdArgs: the
// sizes, the strides, the dtype codes, the flags and the dropout mask's
// threshold, scale and coordinates. kernels/ops.py builds that
// block once per launch plan (a ctypes.Structure of this layout, fields in
// this order) and hands the same block to every call of that plan, so a
// call converts a dozen arguments instead of some fifty. The block is only
// read here: calls from several host threads may share it. The device is
// made current by launch_common.cuh's DeviceScope.

#pragma once

#include <cuda_runtime.h>

#include "dropout_mask.cuh"
#include "launch_common.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, three per
// tensor (batch, head, token) in the order the struct names the tensors.
// dropout: 0, or 1 with the keep threshold (keep iff hash < threshold),
// inv_keep = 1 / (1 - rate) in fp32 and the mask's global coordinates
// (dropout_mask.cuh).
// ws_rows: the batch*head rows of the windowed routes' scores workspace
// (flash_scores.cuh), which they fill and read a slab of ws_rows rows at a
// time (kernels/flash_attention.py: scores_workspace); 0 elsewhere.
struct FlashFwdArgs {
  int device;
  int dtype;
  int out_fp32;
  int batch, heads, seq_len, head_dim;
  int dropout;
  long long strides[12];   // q, k, v, out
  unsigned int threshold;
  float inv_keep;
  unsigned int bh_base, q_base, k_base;
  unsigned int inner_local, inner_global, inner_base;
  int ws_rows;
};

// dq_bf16: 1 writes dq in bf16 (the dq kernels of the wgmma, cluster and
// windowed routes round the fp32 sum once, to nearest even), 0 in fp32.
struct FlashBwdArgs {
  int device;
  int dtype;
  int dkv_fp32;
  int dq_bf16;
  int batch, heads, seq_len, head_dim;
  int dropout;
  long long strides[21];   // q, k, v, g, dq, dk, dv
  unsigned int threshold;
  float inv_keep;
  unsigned int bh_base, q_base, k_base;
  unsigned int inner_local, inner_global, inner_base;
  int ws_rows;
};

}  // extern "C"

namespace {

// The strides of tensor i of an argument block, as a source's Strides.
template <typename S>
S strides_of(const long long* strides, int i) {
  return S{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

template <typename A>
Dropout dropout_of(const A& a, const unsigned int* seed) {
  return Dropout{seed,          a.threshold,    a.inv_keep,
                 a.bh_base,     a.q_base,       a.k_base,
                 a.inner_local, a.inner_global, a.inner_base};
}

}  // namespace
