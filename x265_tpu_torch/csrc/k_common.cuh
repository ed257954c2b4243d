// Shared definitions of the port's hand-written kernels (K1, K2).
//
// Every kernel body is written for one thread block whose threads split
// each stage with strided loops (`for (i = KTID; i < n; i += KNTH)`) and
// meet at KSYNC() between stages; warp-level work is written the same way
// over the lanes of a warp (KLANE / KWS, KSYNCWARP()).  Nothing else
// relies on the block size, so the same source also compiles as plain C++
// (one "thread" per block and per warp, blocks run one after another):
// tests/test_torch_ctu_scan.py and tests/test_torch_me.py build it that way
// with g++ and hold it against the plain torch versions on the CPU, where no
// CUDA compiler exists.  Each device-only construct below (warp and
// half-warp sums, ballots, shuffles, byte permutes, dp2a / dp4a, vector
// loads, the asynchronous copies and the bulk copy's mbarrier) has a host
// twin that gives the same result for one thread.
#pragma once

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define KDEV __device__ __forceinline__
#define KSYNC() __syncthreads()
#define KSYNCWARP() __syncwarp()
#define KTID ((int)threadIdx.x)
#define KNTH ((int)blockDim.x)
#define KLANE ((int)(threadIdx.x & 31))
#define KWARP ((int)(threadIdx.x >> 5))
#define KNWARPS ((int)(blockDim.x >> 5))
#define KWS 32
// threads that share one 8x8 tile in k_psy8 (one row each)
#define K8LANES 8
// the block's aligned groups of 16 lanes (half-warps): this thread's group,
// the number of groups, its lane in the group and the group's size
#define KHALF ((int)(threadIdx.x >> 4))
#define KNHALF ((int)(blockDim.x >> 4))
#define KLANE16 ((int)(threadIdx.x & 15))
#define KHS 16
// one rounding, as XLA:CPU contracts `c + a * b` in the reference
#define KFMA(a, b, c) __fmaf_rn((a), (b), (c))
#define KUNROLL _Pragma("unroll")
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
#define KSYNCWARP() ((void)0)
#define KTID 0
#define KNTH 1
#define KLANE 0
#define KWARP 0
#define KNWARPS 1
#define KWS 1
#define K8LANES 1
#define KHALF 0
#define KNHALF 1
#define KLANE16 0
#define KHS 1
#define KFMA(a, b, c) fmaf((a), (b), (c))
#define KUNROLL
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

// floor(log2(v)) for v > 0
KDEV int k_msb(unsigned v) {
#ifdef __CUDACC__
  return 31 - __clz((int)v);
#else
  return 31 - __builtin_clz(v);
#endif
}

// A team: warps [w0, w0 + nw) of the block, meeting at their own named
// barrier `bar` (0: the whole block's __syncthreads); tid and nth number
// the team's threads as KTID and KNTH number the block's.  Host: the one
// thread is every team (tid 0 of 1), so teams that run side by side on the
// device run one after the other there.
struct KTeam {
  int tid, nth, w0, nw, bar;
};
KDEV KTeam k_team(int w0, int nw, int bar) {
#ifdef __CUDACC__
  return KTeam{KTID - 32 * w0, 32 * nw, w0, nw, bar};
#else
  (void)w0;
  (void)nw;
  (void)bar;
  return KTeam{0, 1, 0, 1, 0};
#endif
}
KDEV bool k_in(const KTeam& t) { return t.tid >= 0 && t.tid < t.nth; }
KDEV void k_team_sync(const KTeam& t) {
#ifdef __CUDACC__
  if (t.bar == 0)
    __syncthreads();
  else
    asm volatile("bar.sync %0, %1;\n" ::"r"(t.bar), "r"(t.nth) : "memory");
#else
  (void)t;
#endif
}

// Sum of v over the lanes of the calling warp (all 32 lanes call it);
// every lane gets the sum.  Host: the one thread's own value.
KDEV int k_warp_sum(int v) {
#ifdef __CUDACC__
  return __reduce_add_sync(0xffffffffu, v);
#else
  return v;
#endif
}

// Minimum of v over the lanes of the calling warp (all 32 lanes call it);
// every lane gets it.  Host: the one thread's own value.
KDEV unsigned k_warp_min(unsigned v) {
#ifdef __CUDACC__
  return __reduce_min_sync(0xffffffffu, v);
#else
  return v;
#endif
}

// The bits of a float as an unsigned int, and back.
KDEV unsigned k_fbits(float f) {
#ifdef __CUDACC__
  return __float_as_uint(f);
#else
  unsigned u;
  memcpy(&u, &f, 4);
  return u;
#endif
}
KDEV float k_bitsf(unsigned u) {
#ifdef __CUDACC__
  return __uint_as_float(u);
#else
  float f;
  memcpy(&f, &u, 4);
  return f;
#endif
}

// Ballot of p over the calling warp (all 32 lanes call it): bit j is set
// when lane j's p holds.  Host: p of the one lane.
KDEV unsigned k_ballot(bool p) {
#ifdef __CUDACC__
  return __ballot_sync(0xffffffffu, p);
#else
  return p ? 1u : 0u;
#endif
}

// v of lane j of the calling warp (all 32 lanes call it).  Host: v.
KDEV int k_shfl(int v, int j) {
#ifdef __CUDACC__
  return __shfl_sync(0xffffffffu, v, j);
#else
  (void)j;
  return v;
#endif
}

// Sum of v over the 16 lanes of the calling half-warp (all 16 call it; the
// other half may be elsewhere); every lane gets the sum.  Host: v.
KDEV int k_sum16(int v) {
#ifdef __CUDACC__
  const unsigned m = 0xffffu << (threadIdx.x & 16);
  for (int s = 8; s > 0; s >>= 1) v += __shfl_xor_sync(m, v, s, 16);
  return v;
#else
  return v;
#endif
}

// Minimum of v over the 16 lanes of the calling half-warp (all 16 call it;
// the other half may be elsewhere); every lane gets it.  Host: v.
KDEV unsigned k_min16(unsigned v) {
#ifdef __CUDACC__
  const unsigned m = 0xffffu << (threadIdx.x & 16);
  for (int s = 8; s > 0; s >>= 1) {
    const unsigned o = __shfl_xor_sync(m, v, s, 16);
    v = o < v ? o : v;
  }
  return v;
#else
  return v;
#endif
}

// Bytes of the 8-byte value (b:a) picked by the four nibbles of sel, byte 0
// of the result by the lowest (PTX prmt, __byte_perm).
KDEV unsigned k_prmt(unsigned a, unsigned b, unsigned sel) {
#ifdef __CUDACC__
  return __byte_perm(a, b, sel);
#else
  const uint64_t ab = (uint64_t)a | ((uint64_t)b << 32);
  unsigned r = 0;
  for (int n = 0; n < 4; ++n)
    r |= (unsigned)((ab >> (8 * ((sel >> (4 * n)) & 7))) & 0xff) << (8 * n);
  return r;
#endif
}

// c + sum of the unsigned bytes of a times the signed bytes of b.  Device:
// one dp4a instruction (PTX dp4a.u32.s32).
KDEV int k_dp4a_us(unsigned a, int b, int c) {
#ifdef __CUDACC__
  int d;
  asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
#else
  for (int n = 0; n < 4; ++n)
    c += (int)((a >> (8 * n)) & 0xff) * (int)(int8_t)((b >> (8 * n)) & 0xff);
  return c;
#endif
}

// index of the lowest set bit of v != 0
KDEV int k_lsb(unsigned v) {
#ifdef __CUDACC__
  return __ffs((int)v) - 1;
#else
  return __builtin_ctz(v);
#endif
}

// Two int16 values p[0], p[1] (4-byte aligned) as one int, p[0] in the low
// half; and four, p[0..3] (8-byte aligned), as two such ints.  One load on
// the device.
KDEV int k_ld2s(const short* p) {
#ifdef __CUDACC__
  return *(const int*)p;
#else
  int v;
  memcpy(&v, p, 4);
  return v;
#endif
}
struct KI2 {
  int lo, hi;
};
KDEV KI2 k_ld4s(const short* p) {
#ifdef __CUDACC__
  const int2 v = *(const int2*)p;
  return KI2{v.x, v.y};
#else
  KI2 v;
  memcpy(&v.lo, p, 4);
  memcpy(&v.hi, p + 2, 4);
  return v;
#endif
}

// c + a0 * b0 + a1 * b1 for the signed int16 halves a0 (low), a1 of a and
// the signed bytes b0, b1 of b: bytes 0, 1 (lo) or 2, 3 (hi).  Device: one
// dp2a instruction.
#ifdef __CUDACC__
KDEV int k_dp2a_lo(int a, int b, int c) { return __dp2a_lo(a, b, c); }
KDEV int k_dp2a_hi(int a, int b, int c) { return __dp2a_hi(a, b, c); }
#else
static inline int k_dp2(int a, int b, int c, int sh) {
  const int a0 = (int16_t)(a & 0xffff), a1 = (int16_t)((unsigned)a >> 16);
  const int b0 = (int8_t)((b >> sh) & 0xff), b1 = (int8_t)((b >> (sh + 8)) & 0xff);
  return c + a0 * b0 + a1 * b1;
}
KDEV int k_dp2a_lo(int a, int b, int c) { return k_dp2(a, b, c, 0); }
KDEV int k_dp2a_hi(int a, int b, int c) { return k_dp2(a, b, c, 16); }
#endif

// Row-major position (y * 4 + x) of rank `rank` of the 4x4 up-right
// diagonal scan, from a table of 16 nibbles (no divergent table loads).
KDEV int k_diag4_pos(int rank) {
  return (int)((0xfbe7ad369c258140ull >> (4 * rank)) & 15u);
}

// Rank of (x, y) in the up-right diagonal scan of an m x m grid (the
// diagonals x + y = s in turn, x rising along each).
KDEV int k_diag_rank(int x, int y, int m) {
  const int s = x + y;
  if (s < m) return s * (s + 1) / 2 + x;
  return m * m - (2 * m - 1 - s) * (2 * m - s) / 2 + x - (s - m + 1);
}

// v added to *p atomically (global memory).  Host: a plain add.
KDEV void k_atomic_add(int* p, int v) {
#ifdef __CUDACC__
  atomicAdd(p, v);
#else
  *p += v;
#endif
}

// *p = min(*p, v) atomically (shared memory).  Host: a plain min.
KDEV void k_atomic_min64(unsigned long long* p, unsigned long long v) {
#ifdef __CUDACC__
  atomicMin(p, v);
#else
  if (v < *p) *p = v;
#endif
}

// A float as an unsigned key whose order is the float's (no NaN), -0 as
// +0; and back.
KDEV unsigned k_fkey(float f) {
  const unsigned u = k_fbits(f == 0.0f ? 0.0f : f);
  return u & 0x80000000u ? ~u : u | 0x80000000u;
}
KDEV float k_keyf(unsigned k) {
  return k_bitsf(k & 0x80000000u ? k & 0x7fffffffu : ~k);
}

// Sign-hiding parity fix of one 4x4 group of levels (the reference's
// sign_hide_diag): when `on`, the first and last nonzero levels in diagonal
// scan order are more than 3 apart, and the parity of the sum of |levels|
// disagrees with the sign of the first one, that first level moves one
// away from zero.  `*any` says whether the group has a nonzero level.
// Device: the 16 lanes of an aligned half-warp hold the group, lane `rank`
// its level v of that rank (the whole warp calls); returns this lane's
// level after the fix.  Host: the one thread reaches rank 0 first, fixes
// the group in place in `grp` (row stride `stride`) and sets *any; every
// rank then reads its level back from `grp`.
KDEV int k_sign_hide16(int v, int rank, bool on, int* grp, int stride,
                       bool* any) {
#ifdef __CUDACC__
  (void)grp;
  (void)stride;
  const int sh = threadIdx.x & 16;
  const unsigned nz = (__ballot_sync(0xffffffffu, v != 0) >> sh) & 0xffffu;
  const unsigned neg = (__ballot_sync(0xffffffffu, v < 0) >> sh) & 0xffffu;
  const unsigned odd = (__ballot_sync(0xffffffffu, v & 1) >> sh) & 0xffffu;
  *any = nz != 0;
  if (on && nz) {
    const int first = __ffs((int)nz) - 1, last = 31 - __clz((int)nz);
    const bool parity = __popc(odd) & 1, negf = (neg >> first) & 1;
    if (last - first > 3 && parity != negf && rank == first)
      v += v > 0 ? 1 : -1;
  }
  return v;
#else
  (void)v;
  if (rank == 0) {
    int first = 99, last = -1, val = 0, sumabs = 0, fpos = 0;
    for (int r = 0; r < 16; ++r) {
      const int p = k_diag4_pos(r), pos = (p >> 2) * stride + (p & 3);
      const int l = grp[pos];
      if (l != 0) {
        if (first == 99) {
          first = r;
          val = l;
          fpos = pos;
        }
        last = r;
      }
      sumabs += k_abs(l);
    }
    *any = last >= 0;
    if (on && last - first > 3 && ((sumabs & 1) == 1) != (val < 0))
      grp[fpos] += val > 0 ? 1 : -1;
  } else {
    *any = false;
  }
  const int p = k_diag4_pos(rank);
  return grp[(p >> 2) * stride + (p & 3)];
#endif
}

// 8-point Walsh-Hadamard transform in natural (Sylvester) order.
KDEV void k_wht8(int* h) {
  for (int s = 1; s < 8; s <<= 1)
    for (int x = 0; x < 8; ++x)
      if (!(x & s)) {
        const int u = h[x], v = h[x + s];
        h[x] = u + v;
        h[x + s] = u - v;
      }
}

#ifndef __CUDACC__
// AC Hadamard energy of one 8x8 tile: sa8d(tile, 0) - (sum(tile) >> 2).
template <typename T>
static inline int k_energy8(const T* p, int stride) {
  int t[8][8], sum = 0;
  for (int y = 0; y < 8; ++y) {
    for (int x = 0; x < 8; ++x) {
      t[y][x] = p[y * stride + x];
      sum += t[y][x];
    }
    k_wht8(t[y]);
  }
  int sa = 0;
  for (int x = 0; x < 8; ++x) {
    int c[8];
    for (int y = 0; y < 8; ++y) c[y] = t[y][x];
    k_wht8(c);
    for (int y = 0; y < 8; ++y) sa += k_abs(c[y]);
  }
  return ((sa + 2) >> 2) - (sum >> 2);
}
#endif

// |energy(a) - energy(b)| of two 8x8 tiles (the psy-rd term of one tile).
// Device: called by K8LANES = 8 consecutive lanes, lane `row` holding that
// row of both tiles: a row transform per lane, the column transform by xor
// shuffles across the 8 lanes; lane 0 of the group returns the term, the
// others 0.  Host (row == 0): the whole tiles on the one thread.
template <typename TA, typename TB>
KDEV int k_psy8(const TA* a, int sa, const TB* b, int sb, int row) {
#ifdef __CUDACC__
  const unsigned m = 0xffu << (threadIdx.x & 24);
  int ha[8], hb[8], suma = 0, sumb = 0;
  for (int x = 0; x < 8; ++x) {
    ha[x] = a[row * sa + x];
    hb[x] = b[row * sb + x];
    suma += ha[x];
    sumb += hb[x];
  }
  k_wht8(ha);
  k_wht8(hb);
  for (int s = 1; s < 8; s <<= 1)
    for (int x = 0; x < 8; ++x) {
      const int oa = __shfl_xor_sync(m, ha[x], s, 8);
      const int ob = __shfl_xor_sync(m, hb[x], s, 8);
      ha[x] = (row & s) ? oa - ha[x] : ha[x] + oa;
      hb[x] = (row & s) ? ob - hb[x] : hb[x] + ob;
    }
  int aa = 0, ab = 0;
  for (int x = 0; x < 8; ++x) {
    aa += k_abs(ha[x]);
    ab += k_abs(hb[x]);
  }
  for (int s = 1; s < 8; s <<= 1) {
    aa += __shfl_xor_sync(m, aa, s, 8);
    ab += __shfl_xor_sync(m, ab, s, 8);
    suma += __shfl_xor_sync(m, suma, s, 8);
    sumb += __shfl_xor_sync(m, sumb, s, 8);
  }
  const int ea = ((aa + 2) >> 2) - (suma >> 2);
  const int eb = ((ab + 2) >> 2) - (sumb >> 2);
  return row == 0 ? k_abs(ea - eb) : 0;
#else
  (void)row;
  return k_abs(k_energy8(a, sa) - k_energy8(b, sb));
#endif
}

// One-shot bulk asynchronous copy global -> shared (TMA, cp.async.bulk)
// completing on an mbarrier.  One thread calls k_mbar_init, then
// k_mbar_expect with the total bytes, then k_bulk_load per tile (16-byte
// aligned addresses, sizes a multiple of 16); after a block barrier every
// thread calls k_mbar_wait(bar, 0).  Host: the copy is a memcpy and the
// barrier does nothing.
#ifdef __CUDACC__
KDEV uint32_t k_smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
KDEV void k_mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   k_smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
KDEV void k_mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   k_smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
KDEV void k_bulk_load(void* dst, const void* src, uint32_t bytes,
                      uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(k_smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(k_smem_addr(bar))
      : "memory");
}
KDEV void k_mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(k_smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// 4-byte asynchronous copy global -> shared (cp.async), and the wait for
// all of this thread's; a block barrier after the wait makes the copies
// visible to every thread.  Host: a memcpy, and nothing to wait for.
KDEV void k_copy4_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   k_smem_addr(dst)),
               "l"(src)
               : "memory");
}
KDEV void k_copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Zero n16 16-byte words at p (16-byte aligned), strided over the block.
KDEV void k_zero16(void* p, int n16) {
  for (int i = KTID; i < n16; i += KNTH) ((int4*)p)[i] = make_int4(0, 0, 0, 0);
}
#else
KDEV void k_copy4_async(void* dst, const void* src) { memcpy(dst, src, 4); }
KDEV void k_copy_async_wait() {}
KDEV void k_zero16(void* p, int n16) { memset(p, 0, 16 * (size_t)n16); }
KDEV void k_mbar_init(uint64_t* bar) { *bar = 0; }
KDEV void k_mbar_expect(uint64_t* bar, uint32_t bytes) {
  (void)bar;
  (void)bytes;
}
KDEV void k_bulk_load(void* dst, const void* src, uint32_t bytes,
                      uint64_t* bar) {
  (void)bar;
  memcpy(dst, src, bytes);
}
KDEV void k_mbar_wait(uint64_t* bar, uint32_t parity) {
  (void)bar;
  (void)parity;
}
#endif
