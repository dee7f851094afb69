// Per-device host state of the launch code.
//
// A launch runs on the calling thread's current device: the Python wrappers make
// the tensor's device current first. What the launch code learns once and keeps
// (the SM count, the shared-memory opt-in limit, the persistent grid's cap, the
// opt-in to more dynamic shared memory, which cudaFuncSetAttribute records per
// device, launch plans, tensor maps) belongs to one device, so it lives in arrays
// indexed by the current device's ordinal and is never shared between devices.
#pragma once

#include <cuda_runtime.h>

namespace per_device {

constexpr int kMaxDevices = 64;

// The current device's ordinal in *dev; an error when CUDA reports none or the
// ordinal lies beyond kMaxDevices.
inline cudaError_t current(int* dev) {
  cudaError_t err = cudaGetDevice(dev);
  if (err == cudaSuccess && (*dev < 0 || *dev >= kMaxDevices)) err = cudaErrorInvalidDevice;
  return err;
}

}  // namespace per_device
