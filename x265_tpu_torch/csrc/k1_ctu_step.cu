// K1's C entry point and its instantiations at CTB 64; those at CTB 32
// and 16 are in k1_ctb32.cu and k1_ctb16.cu, those with the RQT split in
// k1_rqt_ctb{64,32,16}.cu.  The kernel is in k1_ctu_step.cuh, whose header
// comment gives its design.

#include "k1_ctu_step.cuh"

#if defined(__CUDACC__) && defined(K1_STAGE_CLOCKS)
extern "C" int k1_stage_clocks(int* lines, long long* t) {
  cudaError_t e = cudaMemcpyFromSymbol(lines, k1_stamp_line,
                                       sizeof(k1_stamp_line));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(t, k1_stamp_t, sizeof(k1_stamp_t));
  return (int)e;
}
#endif

// One wavefront level: p holds the K1_NPTRS pointers in k1_unpack's order,
// L lanes of F frames (frame-major), cw x ch CTBs of size ctb (64, 32 or
// 16).  Returns 0, a CUDA error, -1 for wrong arguments, -2 for another
// CTB size or -3 for a device ordinal beyond K1_MAX_DEVICES.
extern "C" int k1_ctu_step(void* const* p, int np, int L, int F, int cw,
                           int ch, int ctb, int flags, float psyq,
                           void* stream) {
  if (np != K1_NPTRS || F < 1 || L % F) return -1;
  if (ctb != 64 && ctb != 32 && ctb != 16) return -2;
  K1Args a;
  k1_unpack(&a, p, L, F, cw, ch, flags, psyq);
  if (flags & K1_RQT)
    return ctb == 64   ? k1_run_rqt_ctb64(a, stream)
           : ctb == 32 ? k1_run_rqt_ctb32(a, stream)
                       : k1_run_rqt_ctb16(a, stream);
  return ctb == 64   ? k1_run<64, 0>(a, stream)
         : ctb == 32 ? k1_run_ctb32(a, stream)
                     : k1_run_ctb16(a, stream);
}

extern "C" int k1_smem_bytes() { return (int)sizeof(K1Smem); }
