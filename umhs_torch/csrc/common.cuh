// Shared helpers for the hand-written kernels of umhs_torch.
//
// Every source in this directory is compiled on its own by nvcc into a
// shared library with a plain C interface (no PyTorch headers) and loaded
// with ctypes (umhs_torch/ops/_native.py). Launchers take raw device
// pointers and the caller's stream, allocate nothing, and return the
// cudaError_t of the launch so the Python wrapper can raise on it.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* umhs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace umhs {

inline int num_sms() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

}  // namespace umhs
