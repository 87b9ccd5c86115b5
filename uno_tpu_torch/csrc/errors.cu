// Host helpers of the Python wrappers: the name of a cudaError_t returned by
// a launch entry point, for their error messages, and the device limits a
// launch plan is sized to.

#include <cuda_runtime.h>

extern "C" const char* uno_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The SM count of `device` and the shared memory a block may opt in to.
extern "C" int uno_device_limits(int device, int* sms, int* smem_optin) {
  cudaError_t err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return static_cast<int>(err);
}
