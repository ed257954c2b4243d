// K1's instantiations with the RQT split at CTB 32 (the kernel:
// k1_ctu_step.cuh; the entry point: k1_ctu_step.cu), in a source file of
// their own so that they build in parallel with the others.

#include "k1_ctu_step.cuh"

int k1_run_rqt_ctb32(const K1Args& a, void* stream) {
  return k1_run<32, K1_RQT>(a, stream);
}
