// Error text for the codes the hg_* entry points return (cudaError_t).
#include <cuda_runtime.h>

extern "C" const char* hg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
