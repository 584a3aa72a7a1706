// device_query.cu — the device facts and error strings the kernel wrappers
// need (ops/cuda_build.py), with a plain C interface.

#include <cuda_runtime.h>

extern "C" {

// Largest dynamic shared memory one block may opt into on ``device``.
int aqc_max_smem_optin(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return 0;
  return bytes;
}

const char* aqc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
