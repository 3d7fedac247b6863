// The message of a cudaError_t that a launch entry point returned.

#include <cuda_runtime.h>

extern "C" const char* mvae_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
