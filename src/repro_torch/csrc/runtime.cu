// Error text for the status codes the kernel entries return.
#include "common.cuh"

COBRA_API const char* cobra_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
