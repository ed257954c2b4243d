// K2: subpel motion refinement of 16x16 blocks (8- or 10-bit luma).
//
// Replaces x265_tpu/encoder/me_pallas.py make_refine_kernel (body `kernel`
// at :112, pallas_call at :237).  Plain version: refine_plain in
// x265_tpu_torch/encoder/me_cuda.py, the torch twin of refine_round
// (x265_tpu/encoder/device_pipeline.py:729-789).
//
// Per block, from its 25x25 integer window W (top-left at the full-pel
// winner - 4): rounds of 9 candidates center + step * (dy, dx) in
// (-1, 0, 1)^2 row-major order (subme 0: the center only; 1: step 2;
// >= 2: step 2 then step 1 around the winner).  Each candidate: the exact
// separable 8-tap luma MC (horizontal sums, then vertical, +2048 >> 12,
// clip 0..255), the 4x4 Hadamard SATD ((sum |H d H^T| + 1) >> 1 per 4x4),
// cost = fma(lam, bits(dy) + bits(dx), satd) with the block's lambda
// (lam[b * lam_stride]: stride 1 when a launch carries the blocks of
// several frames, each with its frame's lambda; 0 for one lambda), bits
// from the float32 mv_bits table and
// d = mvi * 4 + q - pmv; candidates beyond 4 * mrq qpel cost 2^30.  The
// first of equal costs wins.
//
// What bounds it on an H100: its operations.  At the 1080p shapes (B =
// 8160 blocks a reference) the interpolation, each filtered sample that a
// block's candidates share counted once, and the SATDs' adds come to ~21
// us at the INT32 rate, the bytes (int32 windows, blocks and predictions)
// to ~11 us (chip_smoke.k2_bound computes both from a run's inputs).  v1
// walked the 18 candidates one after another with four barriers each,
// filtered every candidate's samples anew and summed SATD on 16 threads
// into one shared word with atomics (0.34 ms a launch).  v2 runs one
// 160-thread block per 16x16 block: five warps are ten half-warps, one per
// candidate of a round (9, then 8), and the shared passes (120 horizontal
// tasks, 297 plane tasks) take one or two strides of the block:
//   * staging: every thread copies its own words of the window (two rows
//     of one column), of the source block, of the 14 mv_bits entries
//     the block's candidates can read and of its lambda (in shared memory
//     it holds no register) with 4-byte cp.async, waits for its own
//     copies and lays the window out as bytes (rows 0..23, the only ones
//     |q| <= 3 reaches) and as int16 row pairs;
//   * each round's candidates are evaluated together from shared filtered
//     samples.  Horizontal pass: dp4a of 8-bit samples (unsigned) and
//     signed taps, two per sample, for the phases the block needs (2; and
//     1, 3 when a quarter-pel round follows: every round-2 candidate off
//     the round-1 winner's column has an odd horizontal phase, and 17
//     column bases cover all of them), stored as int16 row pairs.  Round 1
//     then fills the full-pel, H, V and HV planes over the region its 9
//     candidates cover (1,089 samples, dp2a on the row pairs, four or five
//     a sample), and each candidate reads its 16x16 from them.  Round 2's 8
//     new candidates have 8 different phase pairs, so each filters its own
//     samples from the row pairs (no sample is shared), and its center is
//     the round-1 winner, whose cost is reused;
//   * SATD: one half-warp per candidate, one 4x4 Hadamard a lane, the
//     candidate's sum by xor shuffles (no shared atomics);
//   * the argmin: each warp reduces (cost, k), the lower cost first and
//     the lower k between equal costs (the plain version's strict-<
//     row-major scan, ties of masked 2^30 candidates included), as two
//     warp minimums (redux.sync) of the costs' bits and then of k; every
//     warp gets the winner, so no barrier follows;
//   * the winner's prediction is written once, at the end, from its plane
//     (round 1) or its buffer (round 2).
// Block barriers per 16x16 block: 5 at subme >= 2 (staging, horizontal
// pass, planes, round-1 costs, round-2 costs); v1 had ~73.
// Occupancy: the planes and round-2 buffers are bytes (11.5 KB of shared
// memory a block) and __launch_bounds__(160, 8) holds a thread to 48
// registers, so 8 blocks fit an SM.  On an H100 80GB HBM3 at 700 W
// (tools/profile_k2_stages.py, chip_smoke.py), before the last cut of
// instructions: with int32 planes, 56 registers and 21 KB, 5.5 blocks were
// resident and a launch took 0.090 ms; with these settings 7.2 and 0.077
// ms; forced to 32 registers (spilling) 10.9 and 0.079-0.082 ms: every
// stage then took longer, so the SMs' instruction issue, not the blocks'
// latency, limits it from there.
// Phase 0 (an integer position) is not a special case: the tap table's
// {0, 0, 0, 64, ...} row gives 64 * the sample, and the horizontal pass of
// phase 0 stores the sample itself with its 64 (>> (BD - 8)) applied after
// the vertical pass, which is the same integer.
//
// 10 bits (the template parameter BD; K2_BD10 in the C entry point picks
// the instantiation).  The reference's 10-bit MC is the spec's 14-bit
// route (x265_tpu/ops/interp.py mc_luma_batch_ps + uni_round): the
// horizontal pass truncates by >> (BD - 8) = 2, the vertical pass shifts
// >> 6, then (+ 8) >> 4 and a clip to 1023; phase 0 stores the sample and
// multiplies by 64 >> 2 = 16 (= (64 s) >> 2 exactly).  From the vertical
// sums on one shift would do (((x >> 6) + 8) >> 4 == (x + 512) >> 10), but
// not across the horizontal truncation, which stays a step of its own.
// The samples do not fit bytes: the window rows are staged as int16 (24
// a row) and the horizontal pass is four dp2a a sample on int16 pairs
// (odd column bases take their pairs by byte permutes); the filtered row
// pairs fit int16 (|h| <= 112 * 1023 / 4), so the vertical pass and the
// SATDs are the 8-bit ones.  The planes P and round-2 buffers are 16-bit
// (15.2 KB of shared memory a block; 8 blocks an SM still fit).  ptxas
// (sm_90a): 48 registers and 24 bytes of spill stores in both
// instantiations, as the 8-bit kernel had before the 10-bit path.

#include <type_traits>

#include "k_common.cuh"

#define K2_N 16
#define K2_WIN 25
#define K2_MVB 1024
#define K2_THREADS 160
// window rows and columns that candidates with |q| <= 3 qpel read
#define K2_ROWS 24
// row strides: the row-pair planes Hp (in pairs), the round-1 planes P
// (in bytes)
#define K2_HS 20
#define K2_PS 18

// Per quarter-pel phase, HEVC's 8-tap luma filter f0..f7 as signed bytes
// (byte 0 first): {f0..f3}, {f4..f7} (the horizontal pass and even rows of
// the vertical one), then {0, f0, f1, f2}, {f3..f6}, {f7, 0, 0, 0} (odd
// rows of the vertical pass, whose row pairs start one row early).
__constant__ static const int k2_taps[4][5] = {
    {0x40000000, 0x00000000, 0x00000000, 0x00000040, 0x00000000},
    {0x3af604ff, 0x0001fb11, (int)0xf604ff00, 0x01fb113a, 0x00000000},
    {0x28f504ff, (int)0xff04f528, (int)0xf504ff00, 0x04f52828, 0x000000ff},
    {0x11fb0100, (int)0xff04f63a, (int)0xfb010000, 0x04f63a11, 0x000000ff}};

#if defined(__CUDACC__) && defined(K2_STAGE_CLOCKS)
// Stage clocks: the build of tools/profile_k2_stages.py (-DK2_STAGE_CLOCKS),
// the option's only use; nothing outside this block depends on it.  Every
// block barrier of the first K2_STAMP_BLOCKS blocks also stamps its source
// line and clock64() (thread 0, after the barrier), and its SM; line 0
// marks the block's start, -1 its end.  k2_stage_clocks reads the last
// launch's stamps.
#define K2_STAMPS 8
#define K2_STAMP_BLOCKS 8192
static __device__ int k2_stamp_n[K2_STAMP_BLOCKS];
static __device__ int k2_stamp_line[K2_STAMP_BLOCKS * K2_STAMPS];
static __device__ long long k2_stamp_t[K2_STAMP_BLOCKS * K2_STAMPS];
static __device__ int k2_stamp_sm[K2_STAMP_BLOCKS];
KDEV void k2_stamp(int line) {
  __syncthreads();
  const int b = blockIdx.x;
  if (threadIdx.x == 0 && b < K2_STAMP_BLOCKS) {
    if (line == 0) {
      k2_stamp_n[b] = 0;
      unsigned sm;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
      k2_stamp_sm[b] = (int)sm;
    }
    if (k2_stamp_n[b] < K2_STAMPS) {
      const int i = b * K2_STAMPS + k2_stamp_n[b]++;
      k2_stamp_line[i] = line;
      k2_stamp_t[i] = clock64();
    }
  }
}
#undef KSYNC
#define KSYNC() k2_stamp(__LINE__)
#define K2_BLOCK_START() k2_stamp(0)
#define K2_BLOCK_END() k2_stamp(-1)
extern "C" int k2_stage_clocks(int* lines, long long* t, int* sm) {
  cudaError_t e = cudaMemcpyFromSymbol(lines, k2_stamp_line,
                                       sizeof(k2_stamp_line));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(t, k2_stamp_t, sizeof(k2_stamp_t));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(sm, k2_stamp_sm, sizeof(k2_stamp_sm));
  return (int)e;
}
#else
#define K2_BLOCK_START() ((void)0)
#define K2_BLOCK_END() ((void)0)
#endif

#define K2_BD10 1

// a prediction sample in shared memory: a byte at 8 bits, 16 bits at 10
template <int BD>
using K2S = typename std::conditional<BD == 8, u8, unsigned short>::type;

template <int BD>
struct K2Smem {
  int Wi[K2_WIN * K2_WIN];    // the staged window
  int ob[K2_N * K2_N];        // the staged source block
  // window rows 0..23: as bytes, 32 a row (8 bits); as int16, 24 a row
  // (10 bits)
  unsigned Wb[K2_ROWS * (BD == 8 ? 8 : 12)];
  // the horizontal pass of phase fx at column base c, rows r = 2i (low
  // half) and 2i + 1 of the int16 pair at [fx][(i * K2_HS + c) * 2];
  // phase 0 holds W[r][c + 3] itself
  short Hp[4][K2_ROWS / 2 * K2_HS * 2];
  float cost[2][9];
  float bits[2][7];           // mv bits of mv * 4 + q - pmv, q = -3..3
  float lam;                  // the block's lambda
  // the round-1 planes (fy, fx) = (0, 0), (0, 2), (2, 0), (2, 2): final
  // samples of candidate q at row iy1 + y, column ix1 + x
  K2S<BD> P[4][17 * K2_PS];
  K2S<BD> buf[8][K2_N * K2_N];  // round 2: the new candidates' predictions
};

struct K2Blk {
  int mvy, mvx, pmvy, pmvx, mrq;
};

// index in the mv_bits table of the component d = mv * 4 + q - pmv; where
// |d| is beyond the table, its last entry, which only a masked candidate
// reads (k2_cost checks the others)
KDEV int k2_bits_index(int mv, int q, int pmv) {
  const int a = k_abs(mv * 4 + q - pmv);
  return a < K2_MVB ? a : K2_MVB - 1;
}

template <int BD>
KDEV float k2_cost(const K2Smem<BD>* s, int satd, int qy, int qx,
                   const K2Blk& k) {
  const int mqy = k.mvy * 4 + qy, mqx = k.mvx * 4 + qx;
  if (k_abs(mqy) > 4 * k.mrq || k_abs(mqx) > 4 * k.mrq) return 1073741824.0f;
  KCHECK(k_abs(mqy - k.pmvy) < K2_MVB && k_abs(mqx - k.pmvx) < K2_MVB);
  const float bits = s->bits[0][qy + 3] + s->bits[1][qx + 3];
  return KFMA(s->lam, bits, k_i2f(satd));
}

// Copy the block's window rows 0..23, its source block, the 14 mv_bits
// entries its candidates can read and its lambda in (cp.async, each thread
// its own words), then lay the window out as bytes or int16 (Wb) and as the
// phase-0 row pairs (Hp[0]) from the words this thread copied itself; one
// block barrier after it covers all of it.
template <int BD>
KDEV void k2_stage(K2Smem<BD>* s, const int* W, const int* ob,
                   const float* mvb, const float* lam, const K2Blk& k) {
  const int npair = K2_ROWS / 2 * K2_WIN;  // 300 >= 256 >= 14
  for (int t = KTID; t < npair; t += KNTH) {
    const int o = t / K2_WIN * 2 * K2_WIN + t % K2_WIN;
    k_copy4_async(s->Wi + o, W + o);
    k_copy4_async(s->Wi + o + K2_WIN, W + o + K2_WIN);
    if (t < K2_N * K2_N) k_copy4_async(s->ob + t, ob + t);
    if (t < 14) {
      const int q = t % 7 - 3;
      k_copy4_async(&s->bits[t / 7][t % 7],
                    mvb + (t < 7 ? k2_bits_index(k.mvy, q, k.pmvy)
                                 : k2_bits_index(k.mvx, q, k.pmvx)));
    }
    if (t == 14) k_copy4_async(&s->lam, lam);
  }
  k_copy_async_wait();
  for (int t = KTID; t < npair; t += KNTH) {
    const int p = t / K2_WIN, c = t % K2_WIN, o = 2 * p * K2_WIN + c;
    const int a = s->Wi[o], b = s->Wi[o + K2_WIN];
    if constexpr (BD == 8) {
      u8* wb = (u8*)s->Wb;
      wb[2 * p * 32 + c] = (u8)a;
      wb[(2 * p + 1) * 32 + c] = (u8)b;
    } else if (c < K2_ROWS) {
      short* ws = (short*)s->Wb;
      ws[2 * p * K2_ROWS + c] = (short)a;
      ws[(2 * p + 1) * K2_ROWS + c] = (short)b;
    }
    if (c >= 3 && c < 20) {
      s->Hp[0][(p * K2_HS + c - 3) * 2] = (short)a;
      s->Hp[0][(p * K2_HS + c - 3) * 2 + 1] = (short)b;
    }
  }
}

// The horizontal pass over rows 0..23 and column bases 0..16: a task is 4
// bases of one row (the fifth only base 16), for every phase the block
// needs (2; and 1, 3 at subme >= 2), stored as int16 row pairs.
// 8 bits: from three words of the row's bytes (window columns 0..23), whose
// byte windows serve every phase, two dp4a a sample.
template <int BD>
KDEV void k2_hrow(K2Smem<BD>* s, int r, int g, int f0, int f1) {
  const unsigned* row = s->Wb + r * 8 + g;
  const int nj = g < 4 ? 4 : 1;
  const unsigned w0 = row[0], w1 = row[1], w2 = g < 4 ? row[2] : 0u;
  unsigned lo[4], hi[4];
  KUNROLL
  for (int j = 0; j < 4; ++j) {
    const unsigned sel = 0x3210u + 0x1111u * j;
    lo[j] = k_prmt(w0, w1, sel);
    hi[j] = k_prmt(w1, w2, sel);
  }
  for (int fx = f0; fx <= f1; ++fx) {
    const int e0 = k2_taps[fx][0], e1 = k2_taps[fx][1];
    short* out = s->Hp[fx] + ((r >> 1) * K2_HS + 4 * g) * 2 + (r & 1);
    KUNROLL
    for (int j = 0; j < 4; ++j)
      if (j < nj)
        out[2 * j] = (short)k_dp4a_us(hi[j], e1, k_dp4a_us(lo[j], e0, 0));
  }
}

// 10 bits: from six words of the row's int16 pairs (columns 4g..4g+11) and
// the five pairs between them (byte permutes), four dp2a a sample, then
// the spec's >> (BD - 8).
template <int BD>
KDEV void k2_hrow16(K2Smem<BD>* s, int r, int g, int f0, int f1) {
  const short* row = (const short*)s->Wb + r * K2_ROWS + 4 * g;
  const int nj = g < 4 ? 4 : 1;
  int w[6], o[5];
  KUNROLL
  for (int m = 0; m < 6; ++m)
    w[m] = m < 4 || g < 4 ? k_ld2s(row + 2 * m) : 0;
  KUNROLL
  for (int m = 0; m < 5; ++m)  // the pair (4g + 2m + 1, 4g + 2m + 2)
    o[m] = (int)k_prmt((unsigned)w[m], (unsigned)w[m + 1], 0x5432u);
  for (int fx = f0; fx <= f1; ++fx) {
    const int e0 = k2_taps[fx][0], e1 = k2_taps[fx][1];
    short* out = s->Hp[fx] + ((r >> 1) * K2_HS + 4 * g) * 2 + (r & 1);
    KUNROLL
    for (int j = 0; j < 4; ++j)
      if (j < nj) {
        const int* q = j & 1 ? o + (j >> 1) : w + (j >> 1);
        int acc = k_dp2a_lo(q[0], e0, 0);
        acc = k_dp2a_hi(q[1], e0, acc);
        acc = k_dp2a_lo(q[2], e1, acc);
        acc = k_dp2a_hi(q[3], e1, acc);
        out[2 * j] = (short)(acc >> (BD - 8));
      }
  }
}

template <int BD>
KDEV void k2_hpass(K2Smem<BD>* s, int subme) {
  const int f0 = subme >= 2 ? 1 : 2, f1 = subme >= 2 ? 3 : 2;
  for (int t = KTID; t < K2_ROWS * 5; t += KNTH) {
    const int r = t / 5, g = t - 5 * r;
    if constexpr (BD == 8)
      k2_hrow(s, r, g, f0, f1);
    else
      k2_hrow16(s, r, g, f0, f1);
  }
}

// One final sample at row v = 2p + PAR of a column, from the column's
// row-pair words w[0..] of its horizontal phase starting at pair p (w[4]
// only for PAR 1): the vertical taps tp as dp2a, times mul (64 >> (BD - 8)
// where the horizontal phase is 0); 8 bits: +2048 >> 12; 10 bits: >> 6,
// then (+ 8) >> 4; clipped.
template <int PAR, int BD>
KDEV int k2_sample(const int* w, const int* tp, int mul) {
  int acc;
  if (PAR == 0) {
    acc = k_dp2a_lo(w[0], tp[0], 0);
    acc = k_dp2a_hi(w[1], tp[0], acc);
    acc = k_dp2a_lo(w[2], tp[1], acc);
    acc = k_dp2a_hi(w[3], tp[1], acc);
  } else {
    acc = k_dp2a_lo(w[0], tp[2], 0);
    acc = k_dp2a_hi(w[1], tp[2], acc);
    acc = k_dp2a_lo(w[2], tp[3], acc);
    acc = k_dp2a_hi(w[3], tp[3], acc);
    acc = k_dp2a_lo(w[4], tp[4], acc);
  }
  if constexpr (BD == 8)
    return k_clamp((acc * mul + 2048) >> 12, 0, 255);
  else
    return k_clamp((((acc * mul) >> 6) + 8) >> 4, 0, (1 << BD) - 1);
}

// the multiplier of k2_sample for horizontal phase fx
template <int BD>
KDEV int k2_mul(int fx) {
  return fx ? 1 : 64 >> (BD - 8);
}

// Rows v0 .. v0 + nr - 1 (nr <= 4, v0 & 1 == PAR0) of column base c of the
// phases (fy, fx) -- the vertical taps tp of fy, mul of fx, the row pairs H
// of fx -- into out[j * ostride]: the column's six row-pair words loaded
// once (with EDGE, those beyond row 23 read as 0, and no kept row uses
// them; round 2's columns never reach them).
template <int PAR0, bool EDGE, int BD, typename T>
KDEV void k2_column(const short* H, int v0, int c, int nr, const int* tp,
                    int mul, T* out, int ostride) {
  const int p0 = v0 >> 1;
  int w[6];
  KUNROLL
  for (int m = 0; m < 6; ++m)
    w[m] = !EDGE || p0 + m < K2_ROWS / 2
               ? k_ld2s(H + ((p0 + m) * K2_HS + c) * 2) : 0;
  out[0] = (T)k2_sample<PAR0, BD>(w, tp, mul);
  if (nr > 1) out[ostride] = (T)k2_sample<1 - PAR0, BD>(w + PAR0, tp, mul);
  if (nr > 2) out[2 * ostride] = (T)k2_sample<PAR0, BD>(w + 1, tp, mul);
  if (nr > 3)
    out[3 * ostride] = (T)k2_sample<1 - PAR0, BD>(w + 1 + PAR0, tp, mul);
}

KDEV void k2_load_taps(int fy, int* tp) {
  KUNROLL
  for (int m = 0; m < 5; ++m) tp[m] = k2_taps[fy][m];
}

// Round 1's planes: every final sample its candidates read, once.  A task
// is up to 4 rows of one column base of one plane; the planes' tasks come
// in order ((0, 0): 4 row groups x 16 bases, (0, 2): 4 x 17, (2, 0): 5 x
// 16, (2, 2): 5 x 17; row 16 alone in the fifth group), so most warps
// work on one plane.
template <int BD>
KDEV void k2_planes(K2Smem<BD>* s, int subme) {
  for (int t = KTID; t < (subme ? 297 : 64); t += KNTH) {
    const int pl = t < 64 ? 0 : (t < 132 ? 1 : (t < 212 ? 2 : 3));
    const int u = t - (pl == 0 ? 0 : (pl == 1 ? 64 : (pl == 2 ? 132 : 212)));
    const int fy = pl & 2, fx = (pl & 1) * 2;
    const int g = fx ? u / 17 : u >> 4;
    const int c = fx ? u - 17 * g : 1 + (u & 15);
    int tp[5];
    k2_load_taps(fy, tp);
    const int mul = k2_mul<BD>(fx);
    if (fy)
      k2_column<0, true, BD>(s->Hp[fx], 4 * g, c, g == 4 ? 1 : 4, tp, mul,
                             s->P[pl] + 4 * g * K2_PS + c, K2_PS);
    else
      k2_column<1, true, BD>(s->Hp[fx], 1 + 4 * g, c, 4, tp, mul,
                             s->P[pl] + (1 + 4 * g) * K2_PS + c, K2_PS);
  }
}

// The 4x4 prediction p of a round-2 candidate (phases fy, fx) at rows
// v0..v0+3, column bases c0..c0+3, one column at a time.
template <int BD>
KDEV void k2_tile(const short* H, int v0, int c0, const int* tp, int mul,
                  int* p) {
  KUNROLL
  for (int x = 0; x < 4; ++x) {
    if (v0 & 1)
      k2_column<1, false, BD>(H, v0, c0 + x, 4, tp, mul, p + x, 4);
    else
      k2_column<0, false, BD>(H, v0, c0 + x, 4, tp, mul, p + x, 4);
  }
}

// (sum |H4 d H4^T| + 1) >> 1 of d = o - p, o at row stride K2_N.
KDEV int k2_satd4(const int* p, const int* o) {
  int t[4][4];
  KUNROLL
  for (int y = 0; y < 4; ++y) {  // rows: H4 along x
    int d[4];
    KUNROLL
    for (int x = 0; x < 4; ++x) d[x] = o[y * K2_N + x] - p[4 * y + x];
    const int s01 = d[0] + d[1], d01 = d[0] - d[1];
    const int s23 = d[2] + d[3], d23 = d[2] - d[3];
    t[y][0] = s01 + s23;
    t[y][1] = d01 + d23;
    t[y][2] = s01 - s23;
    t[y][3] = d01 - d23;
  }
  int sum = 0;
  KUNROLL
  for (int x = 0; x < 4; ++x) {  // columns: H4 along y
    const int s01 = t[0][x] + t[1][x], d01 = t[0][x] - t[1][x];
    const int s23 = t[2][x] + t[3][x], d23 = t[2][x] - t[3][x];
    sum += k_abs(s01 + s23) + k_abs(d01 + d23) + k_abs(s01 - s23) +
           k_abs(d01 - d23);
  }
  return (sum + 1) >> 1;
}

// Index of the candidate with the lowest cost, the lowest index among equal
// costs, over candidates 0..n-1 (cost[k], or cc for k == kc); its cost in
// *best.  The costs are finite and >= 0 (fma of non-negative terms, or
// 2^30), so their bits order as unsigned ints: two warp minimums.  Every
// lane of every warp calls it and gets the result.
KDEV int k2_argmin(const float* cost, int n, int kc, float cc, float* best) {
  unsigned bc = 0xffffffffu, bk = 32;
  for (int k = KLANE; k < n; k += KWS) {
    const unsigned c = k_fbits(k == kc ? cc : cost[k]);
    if (c < bc) {
      bc = c;
      bk = k;
    }
  }
  const unsigned m = k_warp_min(bc);
  *best = k_bitsf(m);
  return (int)k_warp_min(bc == m ? bk : 32u);
}

// round-1 plane of qpel offset (qy, qx), at the candidate's sample (0, 0)
template <int BD>
KDEV const K2S<BD>* k2_plane(K2Smem<BD>* s, int qy, int qx) {
  return s->P[(qy & 2) + ((qx & 3) >> 1)] + ((qy >> 2) + 1) * K2_PS +
         (qx >> 2) + 1;
}

template <int BD>
KDEV void k2_block(K2Smem<BD>* s, int b, const int* W, const int* ob,
                   const int* mvi, const int* pmv, const float* lam_p,
                   const float* mvb, int* q0, int* pred, float* cost,
                   int subme, int mrq, int lam_stride) {
  const K2Blk blk{mvi[2 * b], mvi[2 * b + 1], pmv[2 * b], pmv[2 * b + 1],
                  mrq};
  k2_stage(s, W + (int64_t)b * K2_WIN * K2_WIN, ob + (int64_t)b * K2_N * K2_N,
           mvb, lam_p + (int64_t)b * lam_stride, blk);
  KSYNC();
  if (subme >= 1) {
    k2_hpass(s, subme);
    KSYNC();
  }
  k2_planes(s, subme);
  KSYNC();
  // round 1: the center (subme 0) or the 9 half-pel candidates, one a
  // half-warp, from the planes
  const int step = subme ? 2 : 0, n1 = subme ? 9 : 1;
  for (int j = KHALF; j < n1; j += KNHALF) {
    const int qy = (j / 3 - 1) * step, qx = (j % 3 - 1) * step;
    const K2S<BD>* pl = k2_plane(s, qy, qx);
    int v = 0;
    for (int t = KLANE16; t < 16; t += KHS) {
      const K2S<BD>* pt = pl + (t >> 2) * 4 * K2_PS + (t & 3) * 4;
      int p[16];
      KUNROLL
      for (int i = 0; i < 16; ++i) p[i] = pt[(i >> 2) * K2_PS + (i & 3)];
      v += k2_satd4(p, s->ob + (t >> 2) * 4 * K2_N + (t & 3) * 4);
    }
    v = k_sum16(v);
    if (KLANE16 == 0) s->cost[0][j] = k2_cost(s, v, qy, qx, blk);
  }
  KSYNC();
  float best;
  const int k1 = k2_argmin(s->cost[0], n1, -1, 0.0f, &best);
  int cy = (k1 / 3 - 1) * step, cx = (k1 % 3 - 1) * step;
  int win = -1;  // the round-2 buffer of the winner; -1: a round-1 plane
  if (subme >= 2) {
    // round 2: the 8 quarter-pel candidates around the round-1 winner, one
    // a half-warp, each filtering its own samples; the center is reused
    for (int j = KHALF; j < 8; j += KNHALF) {
      const int k = j + (j >= 4);
      const int qy = cy + k / 3 - 1, qx = cx + k % 3 - 1;
      const int fx = qx & 3, mul = k2_mul<BD>(fx);
      int tp[5];
      k2_load_taps(qy & 3, tp);
      int v = 0;
      for (int t = KLANE16; t < 16; t += KHS) {
        const int v0 = (qy >> 2) + 1 + (t >> 2) * 4;
        const int c0 = (qx >> 2) + 1 + (t & 3) * 4;
        int p[16];
        k2_tile<BD>(s->Hp[fx], v0, c0, tp, mul, p);
        K2S<BD>* bt = s->buf[j] + (t >> 2) * 4 * K2_N + (t & 3) * 4;
        KUNROLL
        for (int i = 0; i < 16; ++i)
          bt[(i >> 2) * K2_N + (i & 3)] = (K2S<BD>)p[i];
        v += k2_satd4(p, s->ob + (t >> 2) * 4 * K2_N + (t & 3) * 4);
      }
      v = k_sum16(v);
      if (KLANE16 == 0) s->cost[1][k] = k2_cost(s, v, qy, qx, blk);
    }
    KSYNC();
    float b2;
    const int k2 = k2_argmin(s->cost[1], 9, 4, best, &b2);
    if (k2 != 4) {
      win = k2 - (k2 > 4);
      cy += k2 / 3 - 1;
      cx += k2 % 3 - 1;
      best = b2;
    }
  }
  const K2S<BD>* src = win >= 0 ? s->buf[win] : k2_plane(s, cy, cx);
  const int stride = win >= 0 ? K2_N : K2_PS;
  for (int i = KTID; i < K2_N * K2_N; i += KNTH)
    pred[(int64_t)b * K2_N * K2_N + i] = src[(i >> 4) * stride + (i & 15)];
  if (KTID == 0) {
    q0[2 * b] = cy;
    q0[2 * b + 1] = cx;
    cost[b] = best;
  }
}

#ifdef __CUDACC__
template <int BD>
__global__ void __launch_bounds__(K2_THREADS, 8)
    k2_kernel(const int* W, const int* ob, const int* mvi, const int* pmv,
              const float* lam, const float* mvb, int* q0, int* pred,
              float* cost, int subme, int mrq, int lam_stride) {
  __shared__ __align__(16) K2Smem<BD> s;
  K2_BLOCK_START();
  k2_block<BD>(&s, blockIdx.x, W, ob, mvi, pmv, lam, mvb, q0, pred, cost,
               subme, mrq, lam_stride);
  K2_BLOCK_END();
}

// flags: K2_BD10 for 10-bit samples
extern "C" int k2_subpel_refine(const int* W, const int* ob, const int* mvi,
                                const int* pmv, const float* lam,
                                const float* mvb, int* q0, int* pred,
                                float* cost, int B, int subme, int mrq,
                                int lam_stride, int flags, void* stream) {
  if (B > 0) {
    if (flags & K2_BD10)
      k2_kernel<10><<<B, K2_THREADS, 0, (cudaStream_t)stream>>>(
          W, ob, mvi, pmv, lam, mvb, q0, pred, cost, subme, mrq, lam_stride);
    else
      k2_kernel<8><<<B, K2_THREADS, 0, (cudaStream_t)stream>>>(
          W, ob, mvi, pmv, lam, mvb, q0, pred, cost, subme, mrq, lam_stride);
  }
  return (int)cudaGetLastError();
}
#else
template <int BD>
static void k2_host(const int* W, const int* ob, const int* mvi,
                    const int* pmv, const float* lam, const float* mvb,
                    int* q0, int* pred, float* cost, int B, int subme,
                    int mrq, int lam_stride) {
  K2Smem<BD>* s = (K2Smem<BD>*)malloc(sizeof(K2Smem<BD>));
  for (int b = 0; b < B; ++b)
    k2_block<BD>(s, b, W, ob, mvi, pmv, lam, mvb, q0, pred, cost, subme,
                 mrq, lam_stride);
  free(s);
}

extern "C" int k2_subpel_refine(const int* W, const int* ob, const int* mvi,
                                const int* pmv, const float* lam,
                                const float* mvb, int* q0, int* pred,
                                float* cost, int B, int subme, int mrq,
                                int lam_stride, int flags, void* stream) {
  (void)stream;
  if (flags & K2_BD10)
    k2_host<10>(W, ob, mvi, pmv, lam, mvb, q0, pred, cost, B, subme, mrq,
                lam_stride);
  else
    k2_host<8>(W, ob, mvi, pmv, lam, mvb, q0, pred, cost, B, subme, mrq,
               lam_stride);
  return 0;
}
#endif
