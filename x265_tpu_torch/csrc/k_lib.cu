// Error strings of the kernel library's C interface.
#include "k_common.cuh"

#ifdef __CUDACC__
extern "C" const char* k_error_string(int code) {
  if (code == -1) return "wrong number of kernel arguments";
  return cudaGetErrorString((cudaError_t)code);
}
#else
extern "C" const char* k_error_string(int code) {
  return code == -1 ? "wrong number of kernel arguments" : "host build error";
}
#endif
