// Names a cudaError_t returned by a launch entry point, for the Python
// wrappers' error messages.

#include <cuda_runtime.h>

extern "C" const char* uno_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
