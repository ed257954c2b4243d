// K1's instantiations with the RQT split at CTB 16 (the kernel:
// k1_ctu_step.cuh; the entry point: k1_ctu_step.cu), in a source file of
// their own so that they build in parallel with the others.

#include "k1_ctu_step.cuh"

int k1_run_rqt_ctb16(const K1Args& a, void* stream) {
  return k1_run<16, K1_RQT>(a, stream);
}
