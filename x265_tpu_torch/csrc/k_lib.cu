// Error strings of the kernel library's C interface.
#include "k_common.cuh"

#ifdef __CUDACC__
extern "C" const char* k_error_string(int code) {
  if (code == -1) return "wrong number of kernel arguments";
  if (code == -2) return "CTB size other than 16, 32 and 64";
  if (code == -3) return "device ordinal beyond K1_MAX_DEVICES";
  return cudaGetErrorString((cudaError_t)code);
}
#else
extern "C" const char* k_error_string(int code) {
  return code == -1   ? "wrong number of kernel arguments"
         : code == -2 ? "CTB size other than 16, 32 and 64"
                      : "host build error";
}
#endif
