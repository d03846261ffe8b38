// Shared C entry point of the kernel library: readable CUDA error names for
// the Python wrappers (ops/build.py:check_launch).
#include <cuda_runtime.h>

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
