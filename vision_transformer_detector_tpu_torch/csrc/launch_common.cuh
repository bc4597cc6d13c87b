// What the C entry points of all nine kernel sources share: the device a
// launch runs on (DeviceScope), and the argument blocks of the four sources
// outside flash attention (layer_norm.cu, dense_mish.cu, int8_dense.cu,
// dropout.cu; the flash blocks are in flash_launch.cuh, which includes this
// header).
//
// An entry point takes the call's device addresses and stream as arguments
// and everything else as one block: the device, the sizes, the dtype codes,
// the flags, eps or the mask's threshold, scale and coordinates, and for the
// two dense sources the instance that runs. kernels/ops.py builds that block
// once per launch plan (a ctypes.Structure of this layout, fields in this
// order) and hands the same block to every call of that plan. A launch only
// reads its block: calls from several host threads (a server's handlers)
// may share it. The one write is the plan query's (vtd_dense_mish_plan,
// vtd_int8_dense_plan), made once while the plan is built, before any call
// can see the block.

#pragma once

#include <cuda_runtime.h>

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16.

// x and out (rows, d) contiguous in dtype, 16-byte aligned; gamma and beta
// contiguous fp32 (d,), 16-byte aligned.
struct LayerNormArgs {
  int device;
  int dtype;
  int rows, d;
  float eps;
};

// request: 0 by shape, 1 guarded, 2 mma.sync, 3 wgmma. aligned16: 1 when x,
// w and out all start on 16-byte boundaries. instance (0 guarded, 1
// mma.sync, 2 wgmma) is written by vtd_dense_mish_plan.
struct DenseMishArgs {
  int device;
  int dtype;
  int m, n, k;
  int apply_mish;
  int request;
  int aligned16;
  int instance;
};

// request: 0 by shape, 1 guarded, 2 codes resident, 3 codes streamed.
// aligned16: 1 when the (N, K) codes are given and they and x start on
// 16-byte boundaries. instance (0 guarded, 1 resident, 2 streamed) is
// written by vtd_int8_dense_plan.
struct Int8DenseArgs {
  int device;
  int x_dtype, out_dtype;
  int m, n, k;
  int apply_mish;
  int request;
  int aligned16;
  int instance;
};

// threshold: keep iff hash < threshold; inv_keep: the fp32 reciprocal of
// 1 - rate; row_base, the row map (inner_local, inner_global, inner_base)
// and col_base place the mask (dropout.cu).
struct DropoutArgs {
  int device;
  int dtype;
  long long rows;
  int cols;
  unsigned int threshold;
  float inv_keep;
  unsigned int row_base, inner_local, inner_global, inner_base, col_base;
};

}  // extern "C"

namespace {

// The device this host thread last made current through a DeviceScope.
thread_local int scope_device = -1;

// Makes `device` the current device for one launch and restores the
// caller's afterwards. Making it current with cudaSetDevice also makes its
// primary context current in this thread, which the driver call that
// encodes tensor maps needs and which a thread that has made no runtime
// call yet (a server's handler thread) lacks; a thread that already runs
// on `device` with it current makes no call but cudaGetDevice.
class DeviceScope {
 public:
  explicit DeviceScope(int device) : device_(device) {
    err_ = cudaGetDevice(&caller_);
    if (err_ != cudaSuccess) return;
    if (caller_ != device || scope_device != device) {
      err_ = cudaSetDevice(device);
      if (err_ == cudaSuccess) scope_device = device;
    }
  }
  ~DeviceScope() {
    if (err_ == cudaSuccess && caller_ != device_ &&
        cudaSetDevice(caller_) == cudaSuccess) {
      scope_device = caller_;
    }
  }
  DeviceScope(const DeviceScope&) = delete;
  DeviceScope& operator=(const DeviceScope&) = delete;
  cudaError_t error() const { return err_; }

 private:
  int device_;
  int caller_ = -1;
  cudaError_t err_;
};

}  // namespace
