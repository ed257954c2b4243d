// Shared definitions of the port's hand-written kernels (K1, K2).
//
// Every kernel body is written for one thread block whose threads split
// each stage with strided loops (`for (i = KTID; i < n; i += KNTH)`) and
// meet at KSYNC() between stages.  Nothing else relies on the block size,
// so the same source also compiles as plain C++ (one "thread" per block,
// blocks run one after another): tests/test_torch_kernels_host.py builds
// it that way with g++ and holds it against the plain torch versions on
// the CPU, where no CUDA compiler exists.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define KDEV __device__ __forceinline__
#define KSYNC() __syncthreads()
#define KTID ((int)threadIdx.x)
#define KNTH ((int)blockDim.x)
// one rounding, as XLA:CPU contracts `c + a * b` in the reference
#define KFMA(a, b, c) __fmaf_rn((a), (b), (c))
#define KADD(p, v) atomicAdd((p), (v))
#define KOR(p, v) atomicOr((p), (v))
#define KCHECK(c) \
  do {            \
    if (!(c)) __trap(); \
  } while (0)
#else
#include <math.h>
#include <stdlib.h>
#define __constant__
#define KDEV static inline
#define KSYNC() ((void)0)
#define KTID 0
#define KNTH 1
#define KFMA(a, b, c) fmaf((a), (b), (c))
#define KADD(p, v) (*(p) += (v))
#define KOR(p, v) (*(p) |= (v))
#define KCHECK(c) \
  do {            \
    if (!(c)) abort(); \
  } while (0)
#endif

typedef unsigned char u8;

// int32 -> float32 with round-to-nearest-even (torch's .to(float32))
KDEV float k_i2f(int v) {
#ifdef __CUDACC__
  return __int2float_rn(v);
#else
  return (float)v;
#endif
}

KDEV int k_clamp(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }
KDEV int k_abs(int v) { return v < 0 ? -v : v; }
