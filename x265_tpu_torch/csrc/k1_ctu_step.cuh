// K1: one wavefront level of the CTU reconstruction scan (8- or 10-bit;
// 64x64 CTBs of four 32x32 quads, 32x32 CTBs of one, each quad four 16x16
// slots; 16x16 CTBs of one slot and no 32x32 candidate).  The kernel's
// body; the entry point and its instantiations are in k1_ctu_step.cu (CTB
// 64), k1_ctb32.cu and k1_ctb16.cu, one compiler process each.
//
// Replaces x265_tpu/encoder/ctu_scan_pallas.py make_pallas_step (body
// `kernel` at :494, pallas_call at :927).  Plain version: CtuScan.make_step
// in x265_tpu_torch/encoder/ctu_scan.py; every output of one launch equals
// one call of that step.
//
// One 768-thread block per lane CTU of the level.  What bounds it on an
// H100: a level has at most 15 lanes (15 of 132 SMs busy) and each lane is
// one long chain of dependent stages, so the kernel is bound by the latency
// of one CTU; its bytes (~120 KB a lane) would take ~0.5 us a level at the
// card's memory rate, and its transforms' multiply-adds less (chip_smoke.py
// computes the bound of a launch).  The design shortens that chain
// (tools/profile_k1_stages.py stamps every barrier of it):
//   * staging: the lane's original samples (in the quads' tiling, which the
//     16x16 slots index as sub-blocks), inter predictions and the packed
//     transform matrices arrive by bulk asynchronous copies (TMA,
//     cp.async.bulk on an mbarrier) issued by one thread, the availability
//     flags by 4-byte cp.async; the others clear the recon buffers and load
//     the frontiers; nothing is read from global memory after that;
//   * one joint TU chain per candidate: the luma block and its two chroma
//     blocks go through forward rows, forward columns + quant, sign hiding
//     (ballots over the 16 lanes of a 4x4 group) + dequant + bit counts,
//     inverse columns, inverse rows + recon + SSD -- five barriers -- with
//     one element per thread in every pass;
//   * the transforms as int16 x int8 dot products (dp2a, two multiply-adds
//     an instruction) on int16 work buffers, the DCT matrices as bytes in
//     the layout each pass reads, shared rows broadcast and the other
//     operand at consecutive words: no bank conflicts;
//   * two teams of warps: while 12 warps run the quad's four 16x16 slots
//     (384 chain elements, one a thread), the other 12 run its 32x32 intra
//     candidate, each team on its own named barrier (both read only the
//     quad's neighbours and write disjoint buffers); the inter TU32 trial,
//     the psy terms and the decision then run on the whole block;
//   * reference preparation on one warp per plane, in registers: the
//     gather, the substitution by ballots and shuffles, the [1 2 1] filter
//     or strong smoothing by shuffles, the DC sum as a warp sum;
//   * the psy energy of all the quad's chains in one pass, 8 threads per
//     8x8 tile, columns through shuffles;
//   * RD sums kept in registers, summed per warp (__reduce_add_sync), and
//     turned into float costs by one lane per chain in the plain step's
//     order (SSD and bit counts to float32, `lam * bits` and `plam * psy`
//     fused, the file compiled with --fmad=false so nothing else is
//     contracted);
//   * the recon buffers C / Cc are int16, and the new frontier rows,
//     columns and corners are written in place: a level's lanes lie on
//     cx + 2 cy = const, so a lane writes rowf[cx], colf[cy] and
//     corn[cx + 1][cy & 1], which no other real lane of the level reads
//     (dummy lanes, cx == cw, all compute the same values from nothing but
//     padding, and no real lane depends on what they write);
//   * one launch may carry the lanes of F frames (the batched B frames of
//     a mini-GOP): L = F x the level's lanes, frame-major, and each frame
//     has its own frontiers, so lane l reads and writes only those of
//     frame l / (L / F).  The level of a frame puts at most 15 blocks on
//     132 SMs, so F frames' lanes cost about one frame's launch.
//   * the bit depth BD (8 or 10) is a template parameter of the lane and
//     of every function with a depth-dependent constant: the forward rows'
//     shift log2 n + BD - 9, the quant's qbits 14 + qp / 6 + 15 - BD -
//     log2 n, the dequant's shift BD + log2 n - 5, the inverse rows' shift
//     20 - BD, the clamps to 2^BD - 1, the substitution default 2^(BD-1)
//     and the strong-smoothing threshold 2^(BD-5).  The flag K1_BD10 picks
//     the instantiation; both share the shared-memory layout.
// The int16 buffers hold what the plain step holds in int32 at both depths:
// residuals of samples and predictions (|r| <= 1023), the forward rows'
// outputs (the largest row of T sums to 64 n, so at most 1023 * 64 * n >>
// (log2 n + 1) = 32736 at 10 bits and 255 * 64 * n >> (log2 n - 1) =
// 32640 at 8; dp2a on int16 x int8 stays exact), clipped dequant levels and
// inverse outputs.  The SSD sums are int32 per plane as in the plain step:
// a 32x32 luma block's is at most 1024 * 1023^2 < 2^31, converted to
// float32 with round to nearest (k_i2f).
// Per quad: 7 block barriers for the 32x32 intra candidate, 7 per 16x16
// slot (5 for an inter slot), 6 for the inter TU32 trial, 3 for the
// decision and the write-back.
//   RDOQ (K1_RDOQ, the psy-RDOQ strength in K1Args::psyq) and DCT-domain
// noise reduction (K1_NR) live in the chain (k1_chain): NR subtracts the
// position's offset from |coef| in the forward-columns pass and adds the
// raw |coef| to the frame's statistics with global atomics (integers, so
// the order does not matter); RDOQ chooses each element's level there and
// keeps its costs by scan position, then four more team barriers run the
// reference's last-position pass and group zeroing over 4x4 groups (one
// thread a group) and elements (a warp minimum and a shared 64-bit atomic
// minimum of (cost key, scan position): the first minimum, exactly).  Its
// float sums follow XLA's order: sequential inside a group of 16 scan
// positions, the group totals blocked by 16, the group sums in (y, x)
// order; `cost + lambda2 * rate` and `+ lambda2 * last_bits` as fmas.
// With NR every quad runs the TU32 trial in P frames: the plain step adds
// every lane's trial to the statistics, and only m32_in picks its levels.
// The two stages are compiled in or out (k1_kernel<CTB, BD, MODE>, MODE
// the flags K1_RDOQ | K1_NR), the plain ones without the RDOQ scratch at
// the end of K1Smem.
//   The CTB size is the third template parameter (K1Geo): the number of
// quads and slots, the original samples' tile (a quad's 32x32, or at CTB
// 16 the slot's 16x16), the recon buffers' geometry, the frontiers' widths
// and the outputs' shapes follow from it; at CTB 16 the lane runs its one
// slot and no 32x32 candidate, TU32 trial or decision, as the plain step
// does.  A level's lanes still lie on cx + 2 cy = const, so the in-place
// frontier writes hold at every size.  K1Smem keeps the CTB-64 layout at
// every size (one block an SM whatever it asks for: a level has at most
// 60 lanes of a frame, at CTB 16).  Eight instantiations per CTB size,
// each size in its own source file so that the three build in parallel.
//   The inter RQT split candidate (K1_RQT, the fourth MODE bit; its eight
// instantiations per CTB size in k1_rqt_ctb{64,32,16}.cu): after an inter
// slot's TU16 chain, its depth-1 split runs as four chains of one 8x8 luma
// and two 4x4 chroma blocks each (k1_chain<3>: the same passes, T4 for the
// chroma transforms, RDOQ over the sub-blocks but no noise reduction, as
// the plain step's sub-TUs), one after another on the slots' team; then
// the psy terms of both recons (8 tiles), one thread's joint RD compare in
// the plain step's order (c16 = SSD + lam * bits, c8 the same + 9 bits of
// overhead, each + plam * psy, all fused as there), and the winner's recon,
// levels and RD sums (which the 32-vs-16 decision reads) replace the
// slot's.  Its state sits after the RDOQ scratch, so the other modes'
// layout and code are what they were: the plain kernels ask for the first
// 147808 bytes of K1Smem, the RDOQ / NR ones for 181720, the RQT ones for
// all of it, 188000 (of the 232448 a block may have).

#pragma once

#include "k_common.cuh"

#define K1_INTER 1
#define K1_DECIDE32 2
#define K1_PSY 4
#define K1_SIGN_HIDE 8
#define K1_STRONG 16
#define K1_BD10 32
#define K1_RDOQ 64
#define K1_NR 128
#define K1_RQT 256

#define K1_THREADS 768
#define K1_MAXWARPS (K1_THREADS / 32)
// warps of the team that runs the 16x16 slots (one chain element a
// thread); the other 12 run the 32x32 intra candidate meanwhile
#define K1_SLOT_WARPS 12

// The lane's geometry at CTB size CTB (64, 32 or 16).  The recon buffers
// C (luma) and Cc (cb, cr) hold, as the plain step's, the frontier row (2
// CTB wide: this CTU's and the next one's) in row 0, the frontier column
// in column 0, and below the CTU the rows that the bottom-left references
// of its lowest blocks reach.
template <int CTB>
struct K1Geo {
  static constexpr bool has32 = CTB >= 32;  // 32x32 candidates, decide32
  static constexpr int nq = CTB == 64 ? 4 : 1;  // quads
  static constexpr int spq = has32 ? 4 : 1;     // 16x16 slots a quad
  static constexpr int ns = nq * spq;           // slots
  static constexpr int ot = has32 ? 32 : 16;    // original tile side (luma)
  static constexpr int otc = ot / 2;
  static constexpr int ocp = nq * otc * otc;    // o16c's plane stride
  static constexpr int ch = 1 + CTB + ot, cw = 1 + 2 * CTB;  // C
  static constexpr int chc = 1 + CTB / 2 + otc, cwc = 1 + CTB;  // Cc
  // the buffers' sizes in shorts, rounded up to 16 bytes
  static constexpr int cn = (ch * cw + 7) / 8 * 8;
  static constexpr int ccn = (2 * chc * cwc + 7) / 8 * 8;
};

__constant__ static const int k1_angles[33] = {
    32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21, -26, -32,
    -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17, 21, 26, 32};
__constant__ static const int k1_qs[6] = {26214, 23302, 20560,
                                          18396, 16384, 14564};
__constant__ static const int k1_iqs[6] = {40, 45, 51, 57, 64, 72};

struct K1Args {
  const int *cx, *cy, *m16, *m32, *qp_y, *qp_cb, *qp_cr;
  const int *o32y, *o16cb, *o16cr;
  const u8 *l16_av, *c8_av, *l32_av, *c16_av, *quad_ok;
  const float *lam, *plam;
  const u8 *use32, *inter;
  const int *ipy, *ipc;
  const u8* m32in;
  const u8* rqt_ok;  // RQT: the slots that may split [L][ns]
  int* tu8;          // RQT: the slots coded with the split [ns][L]
  const int *rowf, *colf, *rowfb, *colfb, *rowfr, *colfr;
  int *cornf, *cornfb, *cornfr;
  int *lv16, *lv8, *lv32, *lvc16, *sel32, *int_y, *int_c;
  int *nrowf, *ncolf, *nrowfb, *ncolfb, *nrowfr, *ncolfr;
  const int* Tp;  // the packed transform matrices (see K1Smem::Tp)
  // RDOQ: lambda2 and lambda_sad of each QP [64][2], the rate term of each
  // level [32768] (the reference's float values, tables of the wrapper)
  const float *rdlam, *rdrate;
  // noise reduction: the offsets and the statistics, both in the layout
  // K1_NRW (per category [intra, inter] x [n * n, count]); the statistics
  // [F][K1_NRW], added to atomically
  const int* nroff;
  int* nrstat;
  int L, F, cw, ch, flags;  // L lanes of F frames, frame-major
  float psyq;               // psy-RDOQ strength (luma), 0 when off
};

// noise-reduction layout: words per frame, and each category's offset
// (y16, c8, y32, c16: [intra, inter] x [n * n sums, block count])
#define K1_NRW 3208
KDEV int k1_nr_base(int lg, bool luma) {  // TU size 2^lg
  return luma ? (lg == 4 ? 0 : 644) : (lg == 3 ? 514 : 2694);
}

// One team's RDOQ scratch, indexed by chain scan position (a block's
// elements in its scan order: 4x4 groups in diagonal order, 16 positions
// each, in diagonal order inside the group).
struct K1Rdoq {
  float jb[1536];  // the chosen candidate's cost, then its prefix sums
  float d0[1536];  // the cost of level 0, then its prefix sums
  short sp[1536];  // the position's element in the block (y * n + x)
  float gs[2][96];  // per group: sum of jb, of d0 in (y, x) order
  float gx[2][96];  // per group: prefix of the group totals in its run of 16
  unsigned long long key[3];  // per block: least (cost key, scan position)
  float tot[3];               // per block: the total of d0
  int live[3];                // noise reduction: a nonzero |coef| seen
};

// chains of one quad: the 32x32 candidate, four slots, the TU32 trial
#define K1_NCHAIN 6

struct K1Smem {
  // staged inputs (bulk copies: 16-byte aligned, sizes multiples of 16);
  // the original samples in the quads' tiling only: slot sl of quad q is
  // the sub-block at x = 16 (sl & 1), y = 16 (sl >> 1) of o32y's tile q and
  // at half that in o16c's tiles
  alignas(16) int o32y[4096];  // [quad][ot][ot]
  alignas(16) int o16c[2048];  // [cb, cr][quad][otc][otc]
  alignas(16) int ipy[4096];   // [slot][16][16]
  alignas(16) int ipc[2048];   // [slot][cb, cr][8][8]
  // the DCT matrices T8 | T16 | T32 as signed bytes, four to a word, in
  // the four layouts of the transform passes (k1_tp); one bulk copy of the
  // wrapper's table
  alignas(16) int Tp[4 * 336];
  uint64_t bar;
  alignas(4) u8 l16av[16 * 65], c8av[16 * 33], l32av[4 * 129], c16av[4 * 65];
  int m16[16], m32[4];
  u8 iv[16], qok[4], m32in[4], use32[4];
  alignas(16) short C[K1Geo<64>::cn];    // [ch][cw] and padding
  alignas(16) short Cc[K1Geo<64>::ccn];  // [cb, cr][chc][cwc] and padding
  // substituted / prediction references and DC values: the slots', the
  // 32x32 candidate's
  short r[3][132], rf[3][132], r32[3][132], rf32[3][132];
  int dc[3], dc32[3];
  // the chains' int16 work buffers (layouts in k1_chain): the slots' and
  // the trial's (the RQT split's four chains at 384..767), the 32x32
  // candidate's
  alignas(16) short wa[1536];
  alignas(16) short wb[1536];
  alignas(16) short wa32[1536];
  alignas(16) short wb32[1536];
  // [luma | cb | cr] layouts: predictions, levels, recons
  int P32[1536], PS[384], IPQ[1536];
  int LV32[1536], LVS[384], LVI[1536];
  short R32[1536], RI[1536];
  int part[K1_NCHAIN][K1_MAXWARPS][6];  // per warp: SSD y/cb/cr, bits
  int psy[48];                          // psy term of each 8x8 tile
  float cost[K1_NCHAIN];                // the chains' RD costs (no psy)
  int psyc[K1_NCHAIN];                  // and psy terms
  int dqmax[3][3];  // k1_dequant_max per plane (y, cb, cr) and log2 size - 3
  int sel, tu32;
  // RDOQ / NR only (last: the plain kernel's shared memory ends before)
  K1Rdoq rq[2];       // RDOQ scratch of the slots' team (and the trial),
                      // and of the 32x32 candidate's
  float rdlam[3][2];  // lambda2, lambda_sad per plane (y, cb, cr)
  // RQT only (last): the split candidate of an inter slot, as four chains
  // [j][luma 8x8 | cb 4x4 | cr 4x4] (j the z-order quadrant)
  int T4[16];          // the DCT matrix T4 in the four layouts, 4 words each
  int P8[384], LV8[384];  // the chains' predictions and levels
  short R8[384];       // their recon: luma 16x16 | cb 8x8 | cr 8x8
  int part8[4][K1_MAXWARPS][6];  // per chain and warp: SSD y/cb/cr, bits
  int psy8[8];         // psy of the TU16 recon's 8x8 tiles, then the split's
  int dqmax2[3];       // k1_dequant_max per plane at 4x4
  u8 rqok[16];         // the slots that may split
  int tu8;             // the slot's decision
};

#if defined(__CUDACC__) && defined(K1_STAGE_CLOCKS)
// Stage clocks: the build of tools/profile_k1_stages.py (-DK1_STAGE_CLOCKS),
// the option's only use; nothing outside this block depends on it.  Every
// block barrier of the first K1_STAMP_BLOCKS blocks also stamps its source
// line and clock64() (thread 0, after the barrier); line 0 marks the start
// of the lane, -1 its end.  k1_stage_clocks (k1_ctu_step.cu) reads the
// last CTB-64 launch's stamps (each source file has its own).
#define K1_STAMPS 1024
#define K1_STAMP_BLOCKS 16
static __device__ int k1_stamp_n[K1_STAMP_BLOCKS];
static __device__ int k1_stamp_line[K1_STAMP_BLOCKS * K1_STAMPS];
static __device__ long long k1_stamp_t[K1_STAMP_BLOCKS * K1_STAMPS];
KDEV void k1_mark(int line) {
  const int b = blockIdx.x;
  if (threadIdx.x == 0 && b < K1_STAMP_BLOCKS) {
    if (line == 0) k1_stamp_n[b] = 0;
    if (k1_stamp_n[b] < K1_STAMPS) {
      const int i = b * K1_STAMPS + k1_stamp_n[b]++;
      k1_stamp_line[i] = line;
      k1_stamp_t[i] = clock64();
    }
  }
}
KDEV void k1_stamp(int line) {
  __syncthreads();
  k1_mark(line);
}
#undef KSYNC
#define KSYNC() k1_stamp(__LINE__)
// a team barrier; stamped when the team holds thread 0
#define K1_TSYNC(t) (k_team_sync(t), k1_mark(__LINE__))
#define K1_LANE_START() k1_stamp(0)
#define K1_LANE_END() k1_stamp(-1)
#else
#define K1_TSYNC(t) k_team_sync(t)
#define K1_LANE_START() ((void)0)
#define K1_LANE_END() ((void)0)
#endif

// floor division / modulo by 6 (torch semantics for any sign)
KDEV int k1_div6(int q) { return q >= 0 ? q / 6 : -((-q + 5) / 6); }
KDEV int k1_mod6(int q) { return q - 6 * k1_div6(q); }
// word offset in K1Smem::Tp of layout `kind` of the 2^lg-point matrix T
// (T[k][m]: frequency k, sample m), each byte one entry:
//   0: [m4][k] = T[k][4 m4 .. 4 m4 + 3]   (forward rows, lane k)
//   1: [k][m4] = T[k][4 m4 .. 4 m4 + 3]   (forward columns, shared row k)
//   2: [m][k4] = T[4 k4 .. 4 k4 + 3][m]   (inverse columns, shared row m)
//   3: [k4][m] = T[4 k4 .. 4 k4 + 3][m]   (inverse rows, lane m)
KDEV int k1_tp(int kind, int lg) {
  return kind * 336 + (lg == 3 ? 0 : (lg == 4 ? 16 : 80));
}
// the start of layout `kind` of the 2^lg-point matrix: T8, T16, T32 in Tp,
// T4 (the RQT chains' chroma) in T4, four words a layout
template <int lg>
KDEV const int* k1_tpp(const K1Smem* s, int kind) {
  if constexpr (lg == 2)
    return s->T4 + 4 * kind;
  else
    return s->Tp + k1_tp(kind, lg);
}

KDEV bool k1_filter_flag(int mode, int n, bool luma) {
  if (!luma || mode == 1) return false;
  int d;
  if (mode == 0) {
    d = 10;
  } else {
    const int a = k_abs(mode - 10), b = k_abs(mode - 26);
    d = a < b ? a : b;
  }
  const int th = n == 8 ? 7 : (n == 16 ? 1 : 0);
  return d > th;
}

// --- reference samples ------------------------------------------------------

// The canonical reference vector of the N x N block at (lx0, ly0) of
// buffer B (row stride `stride`; row/column 0 are the frontier): the spec
// substitution with availability `av`, then the reference filter or strong
// smoothing, and the DC value.  Called by one whole warp, which holds
// sample k = c * KWS + lane in registers (chunk c): the gather, the
// substitution by ballots and shuffles, the filter by shuffles, the DC sum
// as a warp sum; only r and rf are stored.
template <int N, int BD>
KDEV void k1_prep_ref(const short* B, int stride, int lx0, int ly0,
                      const u8* av, short* r, short* rf, int* dc, int mode,
                      bool luma, bool strong) {
  constexpr int R = 4 * N + 1, NC = (R + KWS - 1) / KWS;
  const int lane = KLANE;
  int raw[NC], sub[NC];
  unsigned bal[NC];
  KUNROLL
  for (int c = 0; c < NC; ++c) {  // gather
    const int k = c * KWS + lane;
    raw[c] = k >= R ? 0
             : k <= 2 * N ? B[(ly0 + 2 * N - k) * stride + lx0]
                          : B[ly0 * stride + lx0 + k - 2 * N];
    bal[c] = k_ballot(k < R && av[k]);
  }
  // substitution: the last available sample at or before k; before the
  // first available one, that one; 2^(BD-1) when none is available
  int carry = 1 << (BD - 1);
  bool found = false;
  KUNROLL
  for (int c = 0; c < NC; ++c)
    if (!found && bal[c]) {
      carry = k_shfl(raw[c], k_lsb(bal[c]));
      found = true;
    }
  const unsigned le = 0xffffffffu >> (31 - lane);  // lanes <= this one
  KUNROLL
  for (int c = 0; c < NC; ++c) {
    const unsigned m = bal[c] & le;
    const int got = k_shfl(raw[c], m ? k_msb(m) : 0);
    sub[c] = m ? got : carry;
    if (bal[c]) carry = k_shfl(raw[c], k_msb(bal[c]));
  }
  // the filter: [1 2 1] or strong smoothing, elementwise from neighbours
  const bool filt = k1_filter_flag(mode, N, luma);
  const int bl = k_shfl(sub[0], 0);
  const int corner = k_shfl(sub[2 * N / KWS], 2 * N % KWS);
  const int tr = k_shfl(sub[4 * N / KWS], 4 * N % KWS);
  bool use_strong = false;
  if constexpr (N == 32) {
    const int r32 = k_shfl(sub[32 / KWS], 32 % KWS);
    const int r96 = k_shfl(sub[96 / KWS], 96 % KWS);
    constexpr int thr = 1 << (BD - 5);
    use_strong = luma && strong && filt &&
                 k_abs(corner + tr - 2 * r96) < thr &&
                 k_abs(corner + bl - 2 * r32) < thr;
  }
  int sum = 0;
  KUNROLL
  for (int c = 0; c < NC; ++c) {
    const int k = c * KWS + lane;
    const int lo = c > 0 ? k_shfl(sub[c > 0 ? c - 1 : 0], KWS - 1) : 0;
    const int up = k_shfl(sub[c], lane > 0 ? lane - 1 : 0);
    const int hi = c + 1 < NC ? k_shfl(sub[c + 1 < NC ? c + 1 : c], 0) : 0;
    const int dn = k_shfl(sub[c], lane < KWS - 1 ? lane + 1 : lane);
    const int prv = lane == 0 ? lo : up, nxt = lane == KWS - 1 ? hi : dn;
    int v;
    if (use_strong) {
      if (k == 0)
        v = bl;
      else if (k < 64)
        v = (k * corner + (64 - k) * bl + 32) >> 6;
      else if (k == 64)
        v = corner;
      else if (k < 128)
        v = ((128 - k) * corner + (k - 64) * tr + 32) >> 6;
      else
        v = tr;
    } else if (filt && k > 0 && k < R - 1) {
      v = (prv + 2 * sub[c] + nxt + 2) >> 2;
    } else {
      v = sub[c];
    }
    if (k < R) {
      r[k] = (short)sub[c];
      rf[k] = (short)v;
    }
    if ((k >= N && k < 2 * N) || (k > 2 * N && k <= 3 * N)) sum += v;
  }
  sum = k_warp_sum(sum);
  if (lane == 0) *dc = (sum + N) >> (k_msb(N) + 1);
}

// Prepare the luma (N) and both chroma (N / 2) references of the block at
// luma (x0, y0) into r, rf, dc: warp v of team t does plane v (on the host
// the one thread does all).
template <int CTB, int N, int BD>
KDEV void k1_prep3(K1Smem* s, const KTeam& t, int x0, int y0, const u8* avl,
                   const u8* avc, int mode, bool strong, short (*r)[132],
                   short (*rf)[132], int* dc) {
  using G = K1Geo<CTB>;
  for (int v = KWARP - t.w0; v < 3; v += t.nw) {
    if (v == 0)
      k1_prep_ref<N, BD>(s->C, G::cw, x0, y0, avl, r[0], rf[0], &dc[0], mode,
                         true, strong);
    else
      k1_prep_ref<N / 2, BD>(s->Cc + (v - 1) * G::chc * G::cwc, G::cwc,
                             x0 / 2, y0 / 2, avc, r[v], rf[v], &dc[v], mode,
                             false, false);
  }
}

KDEV int k1_canon(int i, bool vertical, int n, int a) {
  if (i == 0) return 2 * n;
  if (i > 0) return vertical ? 2 * n + i : 2 * n - i;
  int inv = 0;
  switch (a) {
    case -2: inv = -4096; break;
    case -5: inv = -1638; break;
    case -9: inv = -910; break;
    case -13: inv = -630; break;
    case -17: inv = -482; break;
    case -21: inv = -390; break;
    case -26: inv = -315; break;
    default: inv = -256; break;  // -32
  }
  const int sidx = ((i * inv + 128) >> 8) - 1;
  if (sidx < 0) return 2 * n;
  return vertical ? 2 * n - 1 - sidx : 2 * n + 1 + sidx;
}

// One predicted sample (y, x) of mode `mode` from prepared references.
template <int BD>
KDEV int k1_pred_pixel(const short* r, const short* rf, int dc, int mode,
                       int n, int y, int x, bool luma) {
  int v;
  if (mode == 0) {
    const int log2n = k_msb(n);
    v = ((n - 1 - x) * rf[2 * n - 1 - y] + (x + 1) * rf[3 * n + 1] +
         (n - 1 - y) * rf[2 * n + 1 + x] + (y + 1) * rf[n - 1] + n) >>
        (log2n + 1);
  } else if (mode == 1) {
    v = dc;
  } else {
    const int a = k1_angles[mode - 2];
    const bool vertical = mode >= 18;
    const int q = vertical ? y : x, p = vertical ? x : y;
    const int pos = (q + 1) * a;
    const int idx = pos >> 5, fact = pos & 31;
    const int i0 = k1_canon(p + idx + 1, vertical, n, a);
    const int i1 = fact ? k1_canon(p + idx + 2, vertical, n, a) : i0;
    v = ((32 - fact) * rf[i0] + fact * rf[i1] + 16) >> 5;
  }
  if (luma && n < 32) {
    const int corner = r[2 * n];
    if (mode == 1) {
      if (y == 0 && x == 0)
        v = (r[2 * n - 1] + 2 * dc + r[2 * n + 1] + 2) >> 2;
      else if (y == 0)
        v = (r[2 * n + 1 + x] + 3 * dc + 2) >> 2;
      else if (x == 0)
        v = (r[2 * n - 1 - y] + 3 * dc + 2) >> 2;
    } else if (mode == 26 && x == 0) {
      v = k_clamp(r[2 * n + 1] + ((r[2 * n - 1 - y] - corner) >> 1), 0,
                  (1 << BD) - 1);
    } else if (mode == 10 && y == 0) {
      v = k_clamp(r[2 * n - 1] + ((r[2 * n + 1 + x] - corner) >> 1), 0,
                  (1 << BD) - 1);
    }
  }
  return v;
}

// --- the joint transform / quant chain -----------------------------------------

template <int BD>
KDEV int k1_quant(int c, int qp, bool intra, int log2n) {
  const int qbits = 14 + k1_div6(qp) + (15 - BD - log2n);
  const int scale = k1_qs[k1_mod6(qp)];
  const int a = k_abs(c);
  const int hi = a * (scale >> 7), lo = a * (scale & 127);
  const int offset = (intra ? 171 : 85) << (qbits - 9);
  const int level = k_clamp((hi + ((lo + offset) >> 7)) >> (qbits - 7), 0,
                            32767);
  return c < 0 ? -level : (c > 0 ? level : 0);
}

// the level clip bound of k1_dequant (one division, once per lane)
template <int BD>
KDEV int k1_dequant_max(int qp, int log2n) {
  const int scale_eff = (k1_iqs[k1_mod6(qp)] * 16) << k1_div6(qp);
  return (32767 << (BD + log2n - 5)) / scale_eff + 1;
}

template <int BD>
KDEV int k1_dequant(int l, int qp, int log2n, int lmax) {
  const int bd_shift = BD + log2n - 5;
  const int scale_eff = (k1_iqs[k1_mod6(qp)] * 16) << k1_div6(qp);
  const int lv = l > lmax ? lmax : (l < -lmax ? -lmax : l);
  return k_clamp((lv * scale_eff + (1 << (bd_shift - 1))) >> bd_shift, -32768,
                 32767);
}

KDEV int k1_level_bits(int v) {
  const int a = k_abs(v);
  return a == 0 ? 0 : 2 * k_msb((unsigned)a) + 3;
}

// One chain: the luma block (2^LG square) and its two chroma blocks
// (2^(LG-1)), every buffer laid out [luma | cb | cr].
struct K1Chain {
  const int* pred;    // prediction (the caller left orig - pred in wa)
  int* lv;            // levels
  const int* org[3];  // original samples in the quads' tiling: row stride
                      // OT (luma), OT / 2 (chroma); see k1_chain
  short* rec[3];      // recon destinations and their row strides
  int rs[3];
  int* glv[3];  // global level outputs (slots) or null
  int qp[3];
  bool intra;
  short* wa;  // the chain's work buffers
  short* wb;
  K1Rdoq* rq;      // RDOQ / noise-reduction scratch (null without both)
  int* nrs;        // this frame's noise-reduction statistics, or null
  const int* nro;  // the noise-reduction offsets
};

// a[b] by selects (no indexed load from the thread's stack)
template <typename T>
KDEV T k1_pick(const T (&a)[3], int b) {
  return b == 0 ? a[0] : (b == 1 ? a[1] : a[2]);
}

// Block of chain element i (0 luma, 1 cb, 2 cr) and the block's first
// element.
template <int LG>
KDEV int k1_blk(int i) {
  return i < (1 << (2 * LG)) ? 0 : 1 + ((i - (1 << (2 * LG))) >> (2 * LG - 2));
}
template <int LG>
KDEV int k1_base(int b) {
  return b == 0 ? 0 : (1 << (2 * LG)) + ((b - 1) << (2 * LG - 2));
}

// The four transform passes, one output element `off` of a 2^lg block
// each, as int16 x int8 dot products (k_dp2a: two multiply-adds an
// instruction) on int16 data.  The reduction runs over pairs of
// neighbouring int16 values in one word: the row of the forward and
// inverse row passes is contiguous, and the forward rows and the dequant
// write their outputs in the pair layout P of the column passes
// (k1_ppos).  Across the lanes of a warp one operand is shared (broadcast)
// and the other is read at consecutive words: no bank conflicts.

// index of element (y, x) of a 2^lg block in the pair layout P: rows 2p
// and 2p + 1 interleaved, so that word p * 2^lg + x holds (y = 2p, 2p + 1)
KDEV int k1_ppos(int lg, int y, int x) {
  return ((y >> 1) << (lg + 1)) + 2 * x + (y & 1);
}

template <int lg, int BD>
KDEV int k1_fwd_row(const K1Smem* s, const short* x, int off) {  // [y][k]
  constexpr int n = 1 << lg;
  const int y = off >> lg, k = off & (n - 1);
  const short* d = x + (y << lg);
  const int* t = k1_tpp<lg>(s, 0) + k;
  int acc = 0;
  KUNROLL
  for (int m4 = 0; m4 < n / 4; ++m4) {
    const KI2 v = k_ld4s(d + 4 * m4);
    const int w = t[m4 * n];
    acc = k_dp2a_hi(v.hi, w, k_dp2a_lo(v.lo, w, acc));
  }
  return (acc + (1 << (lg + BD - 10))) >> (lg + BD - 9);
}
template <int lg>
KDEV int k1_fwd_col(const K1Smem* s, const short* xp, int off) {  // [v][u]
  constexpr int n = 1 << lg;
  const int v = off >> lg, u = off & (n - 1);
  const int* t = k1_tpp<lg>(s, 1) + v * (n / 4);
  int acc = 0;
  KUNROLL
  for (int m4 = 0; m4 < n / 4; ++m4) {
    const int w = t[m4];
    acc = k_dp2a_lo(k_ld2s(xp + 2 * m4 * 2 * n + 2 * u), w, acc);
    acc = k_dp2a_hi(k_ld2s(xp + (2 * m4 + 1) * 2 * n + 2 * u), w, acc);
  }
  return (acc + (1 << (lg + 5))) >> (lg + 6);
}
template <int lg>
KDEV int k1_inv_col(const K1Smem* s, const short* xp, int off) {  // [y][u]
  constexpr int n = 1 << lg;
  const int y = off >> lg, u = off & (n - 1);
  const int* t = k1_tpp<lg>(s, 2) + y * (n / 4);
  int acc = 0;
  KUNROLL
  for (int v4 = 0; v4 < n / 4; ++v4) {
    const int w = t[v4];
    acc = k_dp2a_lo(k_ld2s(xp + 2 * v4 * 2 * n + 2 * u), w, acc);
    acc = k_dp2a_hi(k_ld2s(xp + (2 * v4 + 1) * 2 * n + 2 * u), w, acc);
  }
  return k_clamp((acc + 64) >> 7, -32768, 32767);
}
template <int lg, int BD>
KDEV int k1_inv_row(const K1Smem* s, const short* e, int off) {  // [y][x]
  constexpr int n = 1 << lg;
  const int y = off >> lg, x = off & (n - 1);
  const short* d = e + (y << lg);
  const int* t = k1_tpp<lg>(s, 3) + x;
  int acc = 0;
  KUNROLL
  for (int u4 = 0; u4 < n / 4; ++u4) {
    const KI2 v = k_ld4s(d + 4 * u4);
    const int w = t[u4 * n];
    acc = k_dp2a_hi(v.hi, w, k_dp2a_lo(v.lo, w, acc));
  }
  return k_clamp((acc + (1 << (19 - BD))) >> (20 - BD), -32768, 32767);
}

KDEV void k1_add3(int* a0, int* a1, int* a2, int b, int v) {
  if (b == 0)
    *a0 += v;
  else if (b == 1)
    *a1 += v;
  else
    *a2 += v;
}

// RDOQ of one coefficient v (after noise reduction) of a 2^lg block at
// QP qp (the reference's _rdoq_core, per element): the candidates 0,
// L - 1, L around the round-nearest level L, their costs D + lambda2 * R
// (one rounding, as XLA contracts it), less the psy-RDOQ bonus psyl * the
// reconstructed amplitude on AC positions; returns the first cheapest
// candidate (signed) and its cost and level 0's in *jb, *d0.
template <int BD>
KDEV int k1_rdoq_level(int v, int qp, int lg, float lam2, float psyl, bool ac,
                       const float* rate, float* jb, float* d0) {
  const int ts = 15 - BD - lg, bd_shift = BD + lg - 5;
  const int qbits = 14 + k1_div6(qp) + ts;
  const int scale = k1_qs[k1_mod6(qp)];
  const int scale_eff = (k1_iqs[k1_mod6(qp)] * 16) << k1_div6(qp);
  const int a = k_abs(v);
  const int hi = a * (scale >> 7), lo = a * (scale & 127);
  const int lmax = k_clamp((hi + ((lo + (1 << (qbits - 1))) >> 7)) >>
                               (qbits - 7),
                           0, 32767);
  const int cand[3] = {0, lmax > 0 ? lmax - 1 : 0, lmax};
  // exact powers of two: the dequant step, the distortion's and the psy
  // amplitude's scales
  const float step = k_i2f(scale_eff) * k_bitsf((unsigned)(127 - bd_shift) << 23);
  const float dsc = k_bitsf((unsigned)(127 - 2 * ts) << 23);
  const float psc = k_bitsf((unsigned)(127 - ts) << 23);
  const float af = k_i2f(a);
  float j[3];
  for (int k = 0; k < 3; ++k) {
    const float dqf = k_i2f(cand[k]) * step;
    const float err = af - dqf;
    const float dist = err * err * dsc;
    if (k == 0) *d0 = dist;
    j[k] = KFMA(lam2, rate[cand[k]], dist);
    if (ac) j[k] = j[k] - psyl * (dqf * psc);
  }
  int best = j[1] < j[0] ? 1 : 0;
  const float jm = j[1] < j[0] ? j[1] : j[0];
  if (j[2] < jm) best = 2;
  *jb = j[2] < jm ? j[2] : jm;
  const int l = k1_pick(cand, best);
  return v < 0 ? -l : l;
}

// Prefix sum of group totals up to group k of a block, the reference's
// blocked order: x[k] is the sum within k's run of 16 groups, then the runs'
// totals (x[15], x[31], x[47]) in turn.
KDEV float k1_group_incl(const float* x, int k) {
  if (k < 16) return x[k];
  float c = x[15];
  for (int h = 1; h < k / 16; ++h) c = c + x[16 * h + 15];
  return c + x[k];
}

// rec = clip(pred + inverse(dequant(sign_hide(quant(forward(wa)))))), the
// level outputs, and, when `rd`, the chain's SSD and bit sums per warp in
// part[] (the psy terms of a quad's chains are taken later, together).
// Run by team t: five team barriers, four more with RDOQ; the per-warp
// sums run after the last one.  OT: the row stride of the original
// samples (K1Geo::ot).  Every pass is one element (or one 4x4
// group) per thread; a warp never straddles two blocks.
//   Noise reduction (c.nrs): the forward columns' |coef| add to the
// frame's statistics and lose the position's offset before quant.
//   RDOQ (c.rq): the forward columns choose each element's level
// (k1_rdoq_level) and keep its costs by scan position; then per group
// the (y, x)-order sums and the prefix sums in scan order (R1), per group
// the prefix of the totals within its run of 16 (R2), per element the
// cost of ending the block there, as a first-minimum over each block
// (warp minimum, then a shared atomic minimum of (cost key, position))
// (R3), and per group the cut after the last position and the group
// zeroing (R4): the reference's last-position and group passes.
//   LG = 3 (the RQT split's chains): the chroma blocks are 4x4, one group
// each, so a warp holds both (cb in its lower half, cr in its upper): R3
// takes its minima over half-warps, and a one-group block's total is its
// group's last prefix sum.
template <int LG, int BD, int MODE, int OT>
KDEV void k1_chain(K1Smem* s, const KTeam& t, const K1Chain& c,
                   bool sign_hide, bool rd, int (*part)[6], const K1Args& ka) {
  constexpr int tot = 6 << (2 * (LG - 1));
  constexpr int ng = tot / 16;  // the chain's 4x4 groups
  short* wa = c.wa;  // the residual, natural layout
  short* wb = c.wb;  // the forward rows' output, pair layout
  K1Rdoq* rq = c.rq;
  constexpr bool rdoq = MODE & K1_RDOQ, nr = MODE & K1_NR;
  for (int i = t.tid; i < tot; i += t.nth) {  // forward rows
    const int b = k1_blk<LG>(i), base = k1_base<LG>(b), off = i - base;
    const int lg = b == 0 ? LG : LG - 1;
    wb[base + k1_ppos(lg, off >> lg, off & ((1 << lg) - 1))] =
        (short)(b == 0 ? k1_fwd_row<LG, BD>(s, wa, i)
                       : k1_fwd_row<LG - 1, BD>(s, wa + base, off));
  }
  if constexpr (rdoq || nr)
    for (int k = t.tid; k < 3; k += t.nth) {
      rq->key[k] = ~0ull;
      rq->live[k] = 0;
    }
  K1_TSYNC(t);
  for (int i = t.tid; i < tot; i += t.nth) {  // forward columns, quant
    const int b = k1_blk<LG>(i), base = k1_base<LG>(b), off = i - base;
    const int lg = b == 0 ? LG : LG - 1;
    int v = b == 0 ? k1_fwd_col<LG>(s, wb, i)
                   : k1_fwd_col<LG - 1>(s, wb + base, off);
    if constexpr (nr) {  // noise reduction: statistics, then the offset
      const int a = k_abs(v);
      const int nb = k1_nr_base(lg, b == 0) + (c.intra ? 0 : (1 << 2 * lg) + 1);
      if (a) {
        k_atomic_add(c.nrs + nb + off, a);
        rq->live[b] = 1;
      }
      const int m = a - c.nro[nb + off];
      v = v < 0 ? -(m > 0 ? m : 0) : (m > 0 ? m : 0);
    }
    if constexpr (rdoq) {
      const int y = off >> lg, x = off & ((1 << lg) - 1);
      const int p = k_diag_rank(x >> 2, y >> 2, 1 << (lg - 2)) * 16 +
                    k_diag_rank(x & 3, y & 3, 4);
      const int bp = base + p;
      const float psyl = b == 0 && ka.psyq > 0.0f ? ka.psyq * s->rdlam[0][1]
                                                 : 0.0f;
      c.lv[i] = k1_rdoq_level<BD>(v, k1_pick(c.qp, b), lg, s->rdlam[b][0],
                                  psyl, psyl > 0.0f && off != 0, ka.rdrate,
                                  &rq->jb[bp], &rq->d0[bp]);
      rq->sp[bp] = (short)off;
    } else {
      c.lv[i] = k1_quant<BD>(v, k1_pick(c.qp, b), c.intra, lg);
    }
  }
  K1_TSYNC(t);
  if constexpr (rdoq) {
    for (int i = t.tid; i < 2 * ng; i += t.nth) {  // R1: per group
      float* v = (i & 1 ? rq->d0 : rq->jb) + 16 * (i >> 1);
      float sum = v[0];  // (y, x) order: rank (x, y) of the 4x4 scan
      for (int k = 1; k < 16; ++k)
        sum = sum + v[(0xfda6eb73c8419520ull >> (4 * k)) & 15u];
      rq->gs[i & 1][i >> 1] = sum;
      float acc = v[0];
      for (int r = 1; r < 16; ++r) {
        acc = acc + v[r];
        v[r] = acc;
      }
    }
    K1_TSYNC(t);
    for (int i = t.tid; i < 2 * ng; i += t.nth) {  // R2: per group
      const int g = i >> 1, q = i & 1;
      const int g0 = k1_base<LG>(k1_blk<LG>(16 * g)) / 16;  // block's first
      const int k = g - g0;
      const float* v = (q ? rq->d0 : rq->jb) + 16 * g0;
      float acc = v[16 * (k & ~15) + 15];
      for (int h = (k & ~15) + 1; h <= k; ++h) acc = acc + v[16 * h + 15];
      rq->gx[q][g] = acc;
    }
    K1_TSYNC(t);
    for (int e = t.tid; e < tot; e += t.nth) {  // R3: per element
      const int b = k1_blk<LG>(e), base = k1_base<LG>(b), p = e - base;
      const int lg = b == 0 ? LG : LG - 1, nb = 1 << lg;
      const int g0 = base / 16, k = p >> 4, nk = nb * nb / 16;
      float cj = rq->jb[e], cd = rq->d0[e];
      if (k > 0) {
        cj = k1_group_incl(rq->gx[0] + g0, k - 1) + cj;
        cd = k1_group_incl(rq->gx[1] + g0, k - 1) + cd;
      }
      float td;
      if constexpr (LG == 3)
        td = nk > 1 ? k1_group_incl(rq->gx[1] + g0, nk - 2) +
                          rq->d0[base + nb * nb - 1]
                    : rq->d0[base + nb * nb - 1];
      else
        td = k1_group_incl(rq->gx[1] + g0, nk - 2) + rq->d0[base + nb * nb - 1];
      const int pos = rq->sp[e];
      const int x = pos & (nb - 1), y = pos >> lg;
      const float lb = k_i2f(2 * k_msb(x + 1) + 2 * k_msb(y + 1) + 2);
      float cost = KFMA(s->rdlam[b][0], lb, cj + (td - cd));
      if (c.lv[base + pos] == 0) cost = k_bitsf(0x7f800000u);  // +inf
      if (p == 0) rq->tot[b] = td;
      const unsigned ck = k_fkey(cost);
      if constexpr (LG == 3) {  // 16-element blocks: half-warp minima
        const unsigned kmin = k_min16(ck);
        const unsigned pmin = k_min16(ck == kmin ? (unsigned)p : ~0u);
        if (KLANE16 == 0)
          k_atomic_min64(&rq->key[b], ((unsigned long long)kmin << 32) | pmin);
      } else {
        const unsigned kmin = k_warp_min(ck);
        const unsigned pmin = k_warp_min(ck == kmin ? (unsigned)p : ~0u);
        if (KLANE == 0)
          k_atomic_min64(&rq->key[b], ((unsigned long long)kmin << 32) | pmin);
      }
    }
    K1_TSYNC(t);
    for (int g = t.tid; g < ng; g += t.nth) {  // R4: per group
      const int b = k1_blk<LG>(16 * g), base = k1_base<LG>(b);
      const float lam2 = s->rdlam[b][0];
      const unsigned long long key = rq->key[b];
      const int pbest = (int)(key & 0xffffffffu);
      const bool keep = k_keyf((unsigned)(key >> 32)) <= rq->tot[b] - lam2 * 2.0f;
      const int k = g - base / 16;
      // the group's levels after the cut: those up to the last position
      const int nkeep = keep ? (pbest - 16 * k + 1 < 16 ? pbest - 16 * k + 1
                                                         : 16)
                             : 0;
      bool nz = false;
      for (int r = 0; r < nkeep; ++r)
        nz = nz || c.lv[base + rq->sp[16 * g + r]] != 0;
      const bool zero = nz && k != pbest >> 4 &&
                        rq->gs[1][g] < rq->gs[0][g] + lam2 * 2.0f;
      for (int r = zero ? 0 : (nkeep > 0 ? nkeep : 0); r < 16; ++r)
        c.lv[base + rq->sp[16 * g + r]] = 0;
    }
    K1_TSYNC(t);
  }
  int s0 = 0, s1 = 0, s2 = 0, b0 = 0, b1 = 0, b2 = 0;
  for (int e = t.tid; e < tot; e += t.nth) {  // sign hiding, bits, dequant
    // elements in 4x4 group order: 16 consecutive lanes, one rank each
    const int b = k1_blk<LG>(e), base = k1_base<LG>(b);
    const int lg = b == 0 ? LG : LG - 1, nb = 1 << lg;
    const int g = (e - base) >> 4, rank = e & 15;
    const int gy = g >> (lg - 2), gx = g & ((nb >> 2) - 1);
    const int p = k_diag4_pos(rank);
    const int pos = (gy * 4 + (p >> 2)) * nb + gx * 4 + (p & 3);
    if constexpr (nr)
      if (e == base && rq->live[b])  // the block's count
        k_atomic_add(c.nrs + k1_nr_base(lg, b == 0) +
                         (c.intra ? 0 : nb * nb + 1) + nb * nb,
                     1);
    bool any;
    const int l = k_sign_hide16(c.lv[base + pos], rank, sign_hide,
                                c.lv + base + (gy * nb + gx) * 4, nb, &any);
    c.lv[base + pos] = l;
    int dqm;
    if constexpr (LG == 3)  // the split's chains: 8x8 luma, 4x4 chroma
      dqm = lg == 2 ? s->dqmax2[b] : s->dqmax[b][0];
    else
      dqm = s->dqmax[b][lg - 3];
    wa[base + k1_ppos(lg, pos >> lg, pos & (nb - 1))] =  // pair layout
        (short)k1_dequant<BD>(l, k1_pick(c.qp, b), lg, dqm);
    int* glv = k1_pick(c.glv, b);
    if (glv) glv[pos] = l;
    k1_add3(&b0, &b1, &b2, b, k1_level_bits(l) + (rank == 0 && any ? 2 : 0));
  }
  K1_TSYNC(t);
  for (int i = t.tid; i < tot; i += t.nth) {  // inverse columns: natural
    const int b = k1_blk<LG>(i), base = k1_base<LG>(b);
    wb[i] = (short)(b == 0 ? k1_inv_col<LG>(s, wa, i)
                           : k1_inv_col<LG - 1>(s, wa + base, i - base));
  }
  K1_TSYNC(t);
  for (int i = t.tid; i < tot; i += t.nth) {  // inverse rows, recon, SSD
    const int b = k1_blk<LG>(i), base = k1_base<LG>(b), off = i - base;
    const int lg = b == 0 ? LG : LG - 1;
    const int res = b == 0 ? k1_inv_row<LG, BD>(s, wb, i)
                           : k1_inv_row<LG - 1, BD>(s, wb + base, off);
    const int rec = k_clamp(c.pred[i] + res, 0, (1 << BD) - 1);
    const int y = off >> lg, x = off & ((1 << lg) - 1);
    k1_pick(c.rec, b)[y * k1_pick(c.rs, b) + x] = (short)rec;
    const int d = rec - k1_pick(c.org, b)[y * (b == 0 ? OT : OT / 2) + x];
    k1_add3(&s0, &s1, &s2, b, d * d);
  }
  K1_TSYNC(t);
  if (!rd) return;
  const int v[6] = {s0, s1, s2, b0, b1, b2};
  for (int k = 0; k < 6; ++k) {
    const int w = k_warp_sum(v[k]);
    if (KLANE == 0) part[KWARP][k] = w;
  }
}

// Float RD cost of chain sums t (the plain step's order and roundings).
KDEV float k1_cost(const int* t, float ovh, float lam) {
  const float fbits = ((k_i2f(t[3]) + k_i2f(t[4])) + k_i2f(t[5])) + ovh;
  const float dist = (k_i2f(t[0]) + k_i2f(t[1])) + k_i2f(t[2]);
  return KFMA(lam, fbits, dist);
}

// --- the RQT split candidate of an inter slot -----------------------------------

// After slot i's TU16 chain (its recon in C, its levels in LVS, its sums in
// part[1 + sl]; its residual's chains staged in P8 and wa[384..768)): the
// four chains of the split, the psy terms, the joint compare, then the
// winner's recon into C, its levels out and, when the split wins, its sums
// in place of the slot's.  Run by the slots' team t.
template <int CTB, int BD, int MODE, int OT>
KDEV void k1_split(K1Smem* s, const KTeam& t, const K1Args& a, int i, int l,
                   int sx, int sy, const int* o16, const int* const* oc8,
                   int qpy, const int* qpc, bool psy, float lam, float plam,
                   bool decide) {
  using G = K1Geo<CTB>;
  constexpr int OTC = OT / 2, CW = G::cw, CHC = G::chc, CWC = G::cwc;
  constexpr int SUB = MODE & K1_RDOQ;  // no noise reduction in the sub-TUs
  const int L = a.L, sl = i % G::spq;
  for (int j = 0; j < 4; ++j) {
    const int jx = j & 1, jy = j >> 1;
    K1Chain c = {s->P8 + 96 * j,
                 s->LV8 + 96 * j,
                 {o16 + 8 * jy * OT + 8 * jx, oc8[0] + 4 * jy * OTC + 4 * jx,
                  oc8[1] + 4 * jy * OTC + 4 * jx},
                 {s->R8 + 8 * jy * 16 + 8 * jx, s->R8 + 256 + 4 * jy * 8 + 4 * jx,
                  s->R8 + 320 + 4 * jy * 8 + 4 * jx},
                 {16, 8, 8},
                 {nullptr, nullptr, nullptr},
                 {qpy, qpc[0], qpc[1]},
                 false,
                 s->wa + 384 + 96 * j,
                 s->wb + 384 + 96 * j,
                 SUB ? &s->rq[0] : nullptr,
                 nullptr,
                 a.nroff};
    k1_chain<3, BD, SUB, OT>(s, t, c, (a.flags & K1_SIGN_HIDE) != 0, true,
                             s->part8[j], a);
  }
  if (psy)  // 8x8 tiles: 0-3 the TU16 recon (in C), 4-7 the split's
    for (int k = t.tid; k < 8 * K8LANES; k += t.nth) {
      const int u = k / K8LANES, row = k - u * K8LANES;
      const int tx = u & 1, ty = (u >> 1) & 1;
      const int e = u < 4 ? k_psy8(o16 + 8 * ty * OT + 8 * tx, OT,
                                   s->C + (1 + sy + 8 * ty) * CW + 1 + sx + 8 * tx,
                                   CW, row)
                          : k_psy8(o16 + 8 * ty * OT + 8 * tx, OT,
                                   s->R8 + 8 * ty * 16 + 8 * tx, 16, row);
      if (row == 0) s->psy8[u] = e;
    }
  K1_TSYNC(t);
  if (t.tid == 0) {  // the plain step's costs: sums over the team's warps
    int t16[6], t8[6];
    for (int k = 0; k < 6; ++k) {
      int v16 = 0, v8 = 0;
      for (int w = t.w0; w < t.w0 + t.nw; ++w) {
        v16 += s->part[1 + sl][w][k];
        for (int j = 0; j < 4; ++j) v8 += s->part8[j][w][k];
      }
      t16[k] = v16;
      t8[k] = v8;
    }
    float c16 = k1_cost(t16, 0.0f, lam), c8 = k1_cost(t8, 9.0f, lam);
    if (psy) {
      c16 = KFMA(plam, k_i2f(s->psy8[0] + s->psy8[1] + s->psy8[2] + s->psy8[3]),
                 c16);
      c8 = KFMA(plam, k_i2f(s->psy8[4] + s->psy8[5] + s->psy8[6] + s->psy8[7]),
                c8);
    }
    const bool tu8 = s->rqok[i] && c8 < c16;
    s->tu8 = tu8;
    a.tu8[i * L + l] = tu8;
  }
  K1_TSYNC(t);
  const bool tu8 = s->tu8;
  for (int k = t.tid; k < 384; k += t.nth) {  // recon, levels out
    int lv;
    if (k < 256) {
      const int y = k >> 4, x = k & 15;
      if (tu8) s->C[(1 + sy + y) * CW + 1 + sx + x] = s->R8[k];
      lv = tu8 ? s->LV8[96 * ((y >> 3) * 2 + (x >> 3)) + (y & 7) * 8 + (x & 7)]
               : s->LVS[k];
      a.lv16[(int64_t)(i * L + l) * 256 + k] = lv;
    } else {
      const int kk = k - 256, p = kk >> 6, j = kk & 63, y = j >> 3, x = j & 7;
      if (tu8)
        s->Cc[p * CHC * CWC + (1 + sy / 2 + y) * CWC + 1 + sx / 2 + x] =
            s->R8[k];
      lv = tu8 ? s->LV8[96 * ((y >> 2) * 2 + (x >> 2)) + 64 + 16 * p +
                        (y & 3) * 4 + (x & 3)]
               : s->LVS[k];
      a.lv8[(int64_t)(i * 2 * L + p * L + l) * 64 + j] = lv;
    }
  }
  if (tu8 && decide)  // the decision reads the split's sums for the slot
    for (int k = t.tid; k < t.nw * 6; k += t.nth) {
      const int w = t.w0 + k / 6, q = k % 6;
      s->part[1 + sl][w][q] = s->part8[0][w][q] + s->part8[1][w][q] +
                              s->part8[2][w][q] + s->part8[3][w][q];
    }
  K1_TSYNC(t);
}

// --- the lane ------------------------------------------------------------------

template <int CTB, int BD, int MODE>
KDEV void k1_lane(K1Smem* s, const K1Args& a, int l) {
  using G = K1Geo<CTB>;
  constexpr int NQ = G::nq, SPQ = G::spq, NS = G::ns, OT = G::ot;
  constexpr int OTC = G::otc, CTBC = CTB / 2;
  constexpr int CW = G::cw, CHC = G::chc, CWC = G::cwc;
  const int L = a.L;
  const bool inter = a.flags & K1_INTER, decide = a.flags & K1_DECIDE32;
  const bool psy = a.flags & K1_PSY, sh = a.flags & K1_SIGN_HIDE;
  const bool strong = a.flags & K1_STRONG;
  constexpr bool rdnr = (MODE & (K1_RDOQ | K1_NR)) != 0;
  constexpr bool rqt = (MODE & K1_RQT) != 0;
  const int cx = a.cx[l], cy = a.cy[l];
  // the lane's frame: lanes are frame-major, L / F to a frame; its
  // frontiers lie at these offsets of rows [F][cw + 1][CTB | CTB / 2],
  // columns [F][ch + 1][CTB | CTB / 2] and corners [F][cw + 2][2]
  const int frame = l / (L / a.F);
  const int rowst = frame * (a.cw + 1), colst = frame * (a.ch + 1);
  const int cornst = frame * (a.cw + 2) * 2;
  int* nrs = MODE & K1_NR ? a.nrstat + (int64_t)frame * K1_NRW : nullptr;
  const int cx1 = cx + 1 < a.cw ? cx + 1 : a.cw;
  const int par = (cy - 1) & 1;
  const int qpy = a.qp_y[l];
  const int qpc[2] = {a.qp_cb[l], a.qp_cr[l]};
  const float lam = decide || rqt ? a.lam[l] : 0.0f;
  const float plam = psy ? a.plam[l] : 0.0f;
  const KTeam all = k_team(0, K1_MAXWARPS, 0);
  const KTeam ts = k_team(0, K1_SLOT_WARPS, 1);
  const KTeam tq = k_team(K1_SLOT_WARPS, K1_MAXWARPS - K1_SLOT_WARPS, 2);

  // staging.  Thread 0 issues the bulk copies (sample tiles, inter
  // predictions, transform matrices); the availability flags arrive by
  // 4-byte asynchronous copies (by byte loads where a lane's flags are not
  // a whole number of words); all threads clear the recon buffers and,
  // after a barrier, load the frontiers into them.
  if (KTID == 0) {
    constexpr uint32_t oyb = 4u * NQ * OT * OT, ocb = 4u * G::ocp;
    const uint32_t nb = oyb + 2 * ocb + 4u * 4 * 336 +
                        (inter ? 4u * NS * (256 + 128) : 0u);
    k_mbar_init(&s->bar);
    k_mbar_expect(&s->bar, nb);
    k_bulk_load(s->o32y, a.o32y + (int64_t)l * NQ * OT * OT, oyb, &s->bar);
    if constexpr (G::has32) {
      k_bulk_load(s->o16c, a.o16cb + (int64_t)l * G::ocp, ocb, &s->bar);
      k_bulk_load(s->o16c + G::ocp, a.o16cr + (int64_t)l * G::ocp, ocb,
                  &s->bar);
    } else {  // the slot's chroma samples [cb, cr][8][8] in one tensor
      k_bulk_load(s->o16c, a.o16cb + (int64_t)l * 2 * G::ocp, 2 * ocb,
                  &s->bar);
    }
    k_bulk_load(s->Tp, a.Tp, 4 * 4 * 336, &s->bar);
    if (inter) {
      k_bulk_load(s->ipy, a.ipy + (int64_t)l * NS * 256, 4u * NS * 256,
                  &s->bar);
      k_bulk_load(s->ipc, a.ipc + (int64_t)l * NS * 128, 4u * NS * 128,
                  &s->bar);
    }
  }
  {  // availability flags: l16, c8 per slot, l32, c16 per quad
    constexpr int n0 = NS * 65, n1 = NS * 33, n2 = NQ * 129, n3 = NQ * 65;
    if constexpr (n0 % 4 == 0 && n1 % 4 == 0 && n2 % 4 == 0 && n3 % 4 == 0) {
      constexpr int w0 = n0 / 4, w1 = w0 + n1 / 4, w2 = w1 + n2 / 4;
      for (int w = KTID; w < w2 + n3 / 4; w += KNTH) {  // 4-byte words
        if (w < w0)
          k_copy4_async(s->l16av + 4 * w, a.l16_av + l * n0 + 4 * w);
        else if (w < w1)
          k_copy4_async(s->c8av + 4 * (w - w0), a.c8_av + l * n1 + 4 * (w - w0));
        else if (w < w2)
          k_copy4_async(s->l32av + 4 * (w - w1), a.l32_av + l * n2 + 4 * (w - w1));
        else
          k_copy4_async(s->c16av + 4 * (w - w2), a.c16_av + l * n3 + 4 * (w - w2));
      }
    } else {
      for (int b = KTID; b < n0 + n1 + n2 + n3; b += KNTH) {  // bytes
        if (b < n0)
          s->l16av[b] = a.l16_av[l * n0 + b];
        else if (b < n0 + n1)
          s->c8av[b - n0] = a.c8_av[l * n1 + b - n0];
        else if (b < n0 + n1 + n2)
          s->l32av[b - n0 - n1] = a.l32_av[l * n2 + b - n0 - n1];
        else
          s->c16av[b - n0 - n1 - n2] = a.c16_av[l * n3 + b - n0 - n1 - n2];
      }
    }
  }
  for (int i = KTID; i < NS; i += KNTH) {
    s->m16[i] = a.m16[l * NS + i];
    s->iv[i] = inter && a.inter[l * NS + i];
  }
  if constexpr (G::has32)
    for (int i = KTID; i < NQ; i += KNTH) {
      s->m32[i] = a.m32[l * NQ + i];
      s->qok[i] = a.quad_ok[l * NQ + i];
      s->m32in[i] = inter && decide && a.m32in[l * NQ + i];
      s->use32[i] = a.use32[l * NQ + i];
    }
  for (int i = KTID; i < 9; i += KNTH) {
    const int b = i / 3, qp = b == 0 ? qpy : (b == 1 ? qpc[0] : qpc[1]);
    s->dqmax[b][i - 3 * b] = k1_dequant_max<BD>(qp, 3 + i - 3 * b);
  }
  if constexpr (rqt) {  // the split's T4 (after the table's T8-T32), 4x4
    // dequant bounds and the slots that may split
    for (int i = KTID; i < 16; i += KNTH) s->T4[i] = a.Tp[4 * 336 + i];
    for (int i = KTID; i < 3; i += KNTH)
      s->dqmax2[i] = k1_dequant_max<BD>(i == 0 ? qpy : qpc[i - 1], 2);
    for (int i = KTID; i < NS; i += KNTH)
      s->rqok[i] = inter && a.rqt_ok[l * NS + i];
  }
  if constexpr (MODE & K1_RDOQ)
    for (int i = KTID; i < 6; i += KNTH) {
      const int b = i >> 1, qp = b == 0 ? qpy : (b == 1 ? qpc[0] : qpc[1]);
      KCHECK(qp >= 0 && qp < 64);  // the table's QPs
      s->rdlam[b][i & 1] = a.rdlam[2 * qp + (i & 1)];
    }
  k_zero16(s->C, G::cn / 8);
  k_zero16(s->Cc, G::ccn / 8);
  KSYNC();
  // the frontiers: luma row 0 (2 CTB), column 0 (CTB), corner; per chroma
  // plane row 0 (CTB), column 0 (CTB / 2), corner
  constexpr int FL = 3 * CTB + 1, FC = 3 * CTBC + 1;
  for (int f = KTID; f < FL + 2 * FC; f += KNTH) {
    short* d;
    int v;
    if (f < FL) {
      if (f < 2 * CTB) {
        d = s->C + 1 + f;
        v = a.rowf[(rowst + (f < CTB ? cx : cx1)) * CTB + (f & (CTB - 1))];
      } else if (f < 3 * CTB) {
        d = s->C + (f - 2 * CTB + 1) * CW;
        v = a.colf[(colst + cy) * CTB + f - 2 * CTB];
      } else {
        d = s->C;
        v = a.cornf[cornst + cx * 2 + par];
      }
    } else {
      const int p = (f - FL) / FC, g = f - FL - FC * p;
      short* Cp = s->Cc + p * CHC * CWC;
      if (g < 2 * CTBC) {
        d = Cp + 1 + g;
        v = (p ? a.rowfr : a.rowfb)[(rowst + (g < CTBC ? cx : cx1)) * CTBC +
                                    (g & (CTBC - 1))];
      } else if (g < 3 * CTBC) {
        d = Cp + (g - 2 * CTBC + 1) * CWC;
        v = (p ? a.colfr : a.colfb)[(colst + cy) * CTBC + g - 2 * CTBC];
      } else {
        d = Cp;
        v = (p ? a.cornfr : a.cornfb)[cornst + cx * 2 + par];
      }
    }
    *d = (short)v;
  }
  k_copy_async_wait();
  KSYNC();
  k_mbar_wait(&s->bar, 0);

  for (int q = 0; q < NQ; ++q) {
    const int qx = (q & 1) * 32, qy = (q >> 1) * 32;
    const int* o32 = s->o32y + q * OT * OT;
    const int* oc32[2] = {s->o16c + q * OTC * OTC,
                          s->o16c + G::ocp + q * OTC * OTC};
    // The 32x32 intra candidate (team tq) and the four 16x16 slots (team
    // ts) read the quad's neighbours and write disjoint buffers, so the
    // two teams run side by side until the block barrier after them.
    if constexpr (G::has32)
      if (k_in(tq)) {  // 32x32 intra candidate: luma and both chroma planes
        const int m32 = s->m32[q];
        k1_prep3<CTB, 32, BD>(s, tq, qx, qy, s->l32av + q * 129,
                              s->c16av + q * 65, m32, strong, s->r32, s->rf32,
                              s->dc32);
        K1_TSYNC(tq);
        for (int i = tq.tid; i < 1536; i += tq.nth) {
          int v, o;
          if (i < 1024) {
            v = k1_pred_pixel<BD>(s->r32[0], s->rf32[0], s->dc32[0], m32, 32,
                                  i >> 5, i & 31, true);
            o = o32[i];
          } else {
            const int k = i - 1024, p = k >> 8, j = k & 255;
            v = k1_pred_pixel<BD>(s->r32[1 + p], s->rf32[1 + p],
                                  s->dc32[1 + p], m32, 16, j >> 4, j & 15,
                                  false);
            o = oc32[p][j];
          }
          s->P32[i] = v;
          s->wa32[i] = (short)(o - v);
        }
        K1_TSYNC(tq);
        K1Chain c32 = {s->P32, s->LV32, {o32, oc32[0], oc32[1]},
                       {s->R32, s->R32 + 1024, s->R32 + 1280}, {32, 16, 16},
                       {0, 0, 0}, {qpy, qpc[0], qpc[1]}, true, s->wa32,
                       s->wb32, rdnr ? &s->rq[1] : nullptr, nrs, a.nroff};
        k1_chain<5, BD, MODE, OT>(s, tq, c32, sh, decide, s->part[0], a);
      }

    for (int sl = 0; sl < SPQ && k_in(ts); ++sl) {
      const int i = q * SPQ + sl;
      const int ox = (sl & 1) * 16, oy = (sl >> 1) * 16;
      const int sx = qx + ox, sy = qy + oy;
      const int m = s->m16[i];
      const bool iv = s->iv[i];
      const int* o16 = o32 + oy * OT + ox;  // row stride OT
      const int* oc8[2] = {oc32[0] + oy / 2 * OTC + ox / 2,
                           oc32[1] + oy / 2 * OTC + ox / 2};  // stride OTC
      const bool split = rqt && iv;  // the slot tries the RQT split
      if (!iv) {
        k1_prep3<CTB, 16, BD>(s, ts, sx, sy, s->l16av + i * 65,
                              s->c8av + i * 33, m, false, s->r, s->rf, s->dc);
        K1_TSYNC(ts);
      }
      for (int k = ts.tid; k < 384; k += ts.nth) {
        int v, o;
        if (k < 256) {
          const int y = k >> 4, x = k & 15;
          v = iv ? s->ipy[i * 256 + k]
                 : k1_pred_pixel<BD>(s->r[0], s->rf[0], s->dc[0], m, 16, y,
                                     x, true);
          s->IPQ[(oy + y) * 32 + ox + x] = v;
          o = o16[y * OT + x];
          if (split) {  // chain j = the z-order 8x8 quadrant
            const int e = 96 * ((y >> 3) * 2 + (x >> 3)) + (y & 7) * 8 + (x & 7);
            s->P8[e] = v;
            s->wa[384 + e] = (short)(o - v);
          }
        } else {
          const int kk = k - 256, p = kk >> 6, j = kk & 63;
          const int y = j >> 3, x = j & 7;
          v = iv ? s->ipc[(i * 2 + p) * 64 + j]
                 : k1_pred_pixel<BD>(s->r[1 + p], s->rf[1 + p],
                                     s->dc[1 + p], m, 8, y, x, false);
          s->IPQ[1024 + p * 256 + (oy / 2 + y) * 16 + ox / 2 + x] = v;
          o = oc8[p][y * OTC + x];
          if (split) {
            const int e = 96 * ((y >> 2) * 2 + (x >> 2)) + 64 + 16 * p +
                          (y & 3) * 4 + (x & 3);
            s->P8[e] = v;
            s->wa[384 + e] = (short)(o - v);
          }
        }
        s->PS[k] = v;
        s->wa[k] = (short)(o - v);
      }
      K1_TSYNC(ts);
      K1Chain cs = {s->PS,
                    s->LVS,
                    {o16, oc8[0], oc8[1]},
                    {s->C + (1 + sy) * CW + 1 + sx,
                     s->Cc + (1 + sy / 2) * CWC + 1 + sx / 2,
                     s->Cc + CHC * CWC + (1 + sy / 2) * CWC + 1 + sx / 2},
                    {CW, CWC, CWC},
                    {split ? nullptr : a.lv16 + (int64_t)(i * L + l) * 256,
                     split ? nullptr : a.lv8 + (int64_t)(i * 2 * L + l) * 64,
                     split ? nullptr
                           : a.lv8 + (int64_t)(i * 2 * L + L + l) * 64},
                    {qpy, qpc[0], qpc[1]},
                    !iv,
                    s->wa,
                    s->wb,
                    rdnr ? &s->rq[0] : nullptr,
                    nrs,
                    a.nroff};
      k1_chain<4, BD, MODE, OT>(s, ts, cs, sh, decide || split,
                                s->part[1 + sl], a);
      if constexpr (rqt) {
        if (split)
          k1_split<CTB, BD, MODE, OT>(s, ts, a, i, l, sx, sy, o16, oc8, qpy,
                                      qpc, psy, lam, plam, decide);
        else if (ts.tid == 0)
          a.tu8[i * L + l] = 0;
      }
    }
    KSYNC();
    if constexpr (G::has32) {
      // the inter TU32 trial of the joined slot predictions; with noise
      // reduction on every quad, as the plain step adds every lane's trial
      // to the statistics (its levels count only under m32_in)
      const bool trial = s->m32in[q] || ((MODE & K1_NR) && inter && decide);
      if (trial) {
        for (int i = KTID; i < 1536; i += KNTH)
          s->wa[i] = (short)((i < 1024 ? o32[i]
                                       : oc32[(i - 1024) >> 8][(i - 1024) & 255]) -
                             s->IPQ[i]);
        KSYNC();
        K1Chain ct = {s->IPQ, s->LVI, {o32, oc32[0], oc32[1]},
                      {s->RI, s->RI + 1024, s->RI + 1280}, {32, 16, 16},
                      {0, 0, 0}, {qpy, qpc[0], qpc[1]}, false, s->wa, s->wb,
                      rdnr ? &s->rq[0] : nullptr, nrs, a.nroff};
        k1_chain<5, BD, MODE, OT>(s, all, ct, sh, true, s->part[5], a);
      }
      if (decide && psy) {  // the psy terms of the quad's chains, 8x8 tiles:
        // 0-15 the 32x32 candidate, 16-31 the slots (4 each), 32-47 the trial
        for (int i = KTID; i < (trial ? 48 : 32) * K8LANES; i += KNTH) {
          const int t = i / K8LANES, row = i - t * K8LANES;
          int e;
          if (t < 16 || t >= 32) {
            const int ty = (t >> 2) & 3, tx = t & 3;
            e = k_psy8(o32 + ty * 256 + tx * 8, 32,
                       (t < 16 ? s->R32 : s->RI) + ty * 256 + tx * 8, 32, row);
          } else {
            const int sl = (t - 16) >> 2, ty = (t >> 1) & 1, tx = t & 1;
            const int ox = (sl & 1) * 16 + tx * 8, oy = (sl >> 1) * 16 + ty * 8;
            e = k_psy8(o32 + oy * 32 + ox, 32,
                       s->C + (1 + qy + oy) * CW + 1 + qx + ox, CW, row);
          }
          if (row == 0) s->psy[t] = e;
        }
      }
      KSYNC();
      if (KWARP == 0) {  // one warp: lane c sums chain c and costs it (the
        // plain step's roundings); lane 0 then takes the decision
        if (decide)
          for (int c = KLANE; c < K1_NCHAIN; c += KWS) {
            const KTeam& tc = c == 0 ? tq : (c < 5 ? ts : all);
            int t[6];
            for (int k = 0; k < 6; ++k) {  // over the warps that ran chain c
              int v = 0;
              for (int w = tc.w0; w < tc.w0 + tc.nw; ++w) v += s->part[c][w][k];
              t[k] = v;
            }
            int ps = 0;
            if (psy) {
              const int t0 = c == 0 ? 0 : (c < 5 ? 12 + 4 * c : 32);
              for (int i = t0; i < t0 + (c == 0 || c == 5 ? 16 : 4); ++i)
                ps += s->psy[i];
            }
            s->cost[c] = k1_cost(t, c == 0 || c == 5 ? 12.0f : 9.0f, lam);
            s->psyc[c] = ps;
          }
        KSYNCWARP();
        if (KLANE == 0) {
          bool u32, tu32 = false;
          if (decide) {
            float c32 = s->cost[0];
            if (psy) c32 = KFMA(plam, k_i2f(s->psyc[0]), c32);
            float cost16 = 0.0f;
            bool any_inter = false;
            for (int sl = 0; sl < 4; ++sl) {
              float c16 = cost16 + s->cost[1 + sl];
              if (psy) c16 = KFMA(plam, k_i2f(s->psyc[1 + sl]), c16);
              cost16 = c16;
              any_inter = any_inter || s->iv[q * 4 + sl];
            }
            u32 = s->qok[q] && (c32 < cost16);
            if (inter) u32 = u32 && !any_inter;
            if (s->m32in[q]) {
              float ci = s->cost[5];
              if (psy) ci = KFMA(plam, k_i2f(s->psyc[5]), ci);
              tu32 = ci < cost16;
            }
          } else {
            u32 = s->use32[q];
          }
          s->sel = u32 || tu32;
          s->tu32 = tu32;
        }
      }
      KSYNC();
      const bool sel = s->sel, tu32 = s->tu32;
      const int* lvf = tu32 ? s->LVI : s->LV32;
      const short* recf = tu32 ? s->RI : s->R32;
      for (int k = KTID; k < 1536; k += KNTH) {
        if (k < 1024) {
          a.lv32[(int64_t)(q * L + l) * 1024 + k] = lvf[k];
          if (sel) s->C[(1 + qy + (k >> 5)) * CW + 1 + qx + (k & 31)] = recf[k];
        } else {
          const int kk = k - 1024, p = kk >> 8, j = kk & 255;
          a.lvc16[(int64_t)(q * 2 * L + p * L + l) * 256 + j] = lvf[k];
          if (sel)
            s->Cc[p * CHC * CWC + (1 + qy / 2 + (j >> 4)) * CWC + 1 + qx / 2 +
                  (j & 15)] = recf[k];
        }
      }
      if (KTID == 0) a.sel32[q * L + l] = sel;
      KSYNC();
    }
  }

  // outputs: the CTU's tiles, then the frontiers and corners in place
  for (int k = KTID; k < CTB * CTB; k += KNTH)
    a.int_y[(int64_t)l * CTB * CTB + k] =
        s->C[(1 + k / CTB) * CW + 1 + (k & (CTB - 1))];
  for (int k = KTID; k < 2 * CTBC * CTBC; k += KNTH) {
    const int p = k / (CTBC * CTBC), j = k & (CTBC * CTBC - 1);
    a.int_c[(int64_t)(p * L + l) * CTBC * CTBC + j] =
        s->Cc[p * CHC * CWC + (1 + j / CTBC) * CWC + 1 + (j & (CTBC - 1))];
  }
  for (int k = KTID; k < CTB; k += KNTH) {
    a.nrowf[(rowst + cx) * CTB + k] = s->C[CTB * CW + 1 + k];
    a.ncolf[(colst + cy) * CTB + k] = s->C[(1 + k) * CW + CTB];
  }
  int* nrowc[2] = {a.nrowfb + rowst * CTBC, a.nrowfr + rowst * CTBC};
  int* ncolc[2] = {a.ncolfb + colst * CTBC, a.ncolfr + colst * CTBC};
  for (int k = KTID; k < 2 * CTBC; k += KNTH) {
    const int p = k / CTBC, j = k & (CTBC - 1);
    nrowc[p][cx * CTBC + j] = s->Cc[p * CHC * CWC + CTBC * CWC + 1 + j];
    ncolc[p][cy * CTBC + j] = s->Cc[p * CHC * CWC + (1 + j) * CWC + CTBC];
  }
  if (KTID == 0) {
    const int slot = cornst + (cx + 1) * 2 + (cy & 1);
    a.cornf[slot] = s->C[CTB * CW + CTB];
    a.cornfb[slot] = s->Cc[CTBC * CWC + CTBC];
    a.cornfr[slot] = s->Cc[CHC * CWC + CTBC * CWC + CTBC];
  }
}

static inline void k1_unpack(K1Args* a, void* const* p, int L, int F, int cw,
                      int ch, int flags, float psyq) {
  int k = 0;
#define NEXT(T) ((T)p[k++])
  a->cx = NEXT(const int*); a->cy = NEXT(const int*);
  a->m16 = NEXT(const int*); a->m32 = NEXT(const int*);
  a->qp_y = NEXT(const int*); a->qp_cb = NEXT(const int*);
  a->qp_cr = NEXT(const int*);
  a->o32y = NEXT(const int*); a->o16cb = NEXT(const int*);
  a->o16cr = NEXT(const int*);
  a->l16_av = NEXT(const u8*); a->c8_av = NEXT(const u8*);
  a->l32_av = NEXT(const u8*); a->c16_av = NEXT(const u8*);
  a->quad_ok = NEXT(const u8*);
  a->lam = NEXT(const float*); a->plam = NEXT(const float*);
  a->use32 = NEXT(const u8*); a->inter = NEXT(const u8*);
  a->ipy = NEXT(const int*); a->ipc = NEXT(const int*);
  a->m32in = NEXT(const u8*);
  a->rqt_ok = NEXT(const u8*); a->tu8 = NEXT(int*);
  a->rowf = NEXT(const int*); a->colf = NEXT(const int*);
  a->cornf = NEXT(int*); a->rowfb = NEXT(const int*);
  a->colfb = NEXT(const int*); a->cornfb = NEXT(int*);
  a->rowfr = NEXT(const int*); a->colfr = NEXT(const int*);
  a->cornfr = NEXT(int*);
  a->lv16 = NEXT(int*); a->lv8 = NEXT(int*); a->lv32 = NEXT(int*);
  a->lvc16 = NEXT(int*); a->sel32 = NEXT(int*); a->int_y = NEXT(int*);
  a->int_c = NEXT(int*);
  a->nrowf = NEXT(int*); a->ncolf = NEXT(int*); a->nrowfb = NEXT(int*);
  a->ncolfb = NEXT(int*); a->nrowfr = NEXT(int*); a->ncolfr = NEXT(int*);
  a->Tp = NEXT(const int*);
  a->rdlam = NEXT(const float*); a->rdrate = NEXT(const float*);
  a->nroff = NEXT(const int*); a->nrstat = NEXT(int*);
#undef NEXT
  a->L = L; a->F = F; a->cw = cw; a->ch = ch; a->flags = flags;
  a->psyq = psyq;
}

#define K1_NPTRS 51
// devices a process may launch K1 on (k1_launch's per-device attribute)
#define K1_MAX_DEVICES 64

#ifdef __CUDACC__
#include <atomic>

// one instantiation per CTB size, bit depth and mode (RDOQ / NR stages
// compiled in or out), so the plain chain carries none of their code
template <int CTB, int BD, int MODE>
__global__ void __launch_bounds__(K1_THREADS) k1_kernel(K1Args a) {
  extern __shared__ __align__(16) unsigned char k1_smem[];
  K1_LANE_START();
  k1_lane<CTB, BD, MODE>((K1Smem*)k1_smem, a, blockIdx.x);
  K1_LANE_END();
}

template <int CTB, int BD, int MODE>
static int k1_launch(const K1Args& a, cudaStream_t stream) {
  // the RDOQ / NR scratch closes K1Smem, then the RQT state: the plain
  // kernel leaves both out, the RDOQ / NR kernels the RQT state
  constexpr int bytes = MODE & K1_RQT ? (int)sizeof(K1Smem)
                        : MODE        ? (int)offsetof(K1Smem, T4)
                                      : (int)offsetof(K1Smem, rq);
  // the attribute is the device's: set it once on each device a launch
  // meets (the calling thread's current one)
  static std::atomic<bool> attr_set[K1_MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= K1_MAX_DEVICES) return -3;
  if (!attr_set[dev].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(k1_kernel<CTB, BD, MODE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set[dev].store(true, std::memory_order_release);
  }
  k1_kernel<CTB, BD, MODE><<<a.L, K1_THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// RQT: 0 or K1_RQT, the instantiations of one source file
template <int CTB, int BD, int RQT>
static int k1_launch_mode(const K1Args& a, cudaStream_t stream) {
  switch (a.flags & (K1_RDOQ | K1_NR)) {
    case K1_RDOQ: return k1_launch<CTB, BD, K1_RDOQ | RQT>(a, stream);
    case K1_NR: return k1_launch<CTB, BD, K1_NR | RQT>(a, stream);
    case K1_RDOQ | K1_NR:
      return k1_launch<CTB, BD, K1_RDOQ | K1_NR | RQT>(a, stream);
    default: return k1_launch<CTB, BD, RQT>(a, stream);
  }
}

// One launch of K1 at CTB size CTB, with or without the RQT split (the
// instantiations of one source file).
template <int CTB, int RQT>
static int k1_run(const K1Args& a, void* stream) {
  return a.flags & K1_BD10
             ? k1_launch_mode<CTB, 10, RQT>(a, (cudaStream_t)stream)
             : k1_launch_mode<CTB, 8, RQT>(a, (cudaStream_t)stream);
}
#else
template <int CTB, int BD, int RQT>
static void k1_host_lane(K1Smem* s, const K1Args& a, int l) {
  switch (a.flags & (K1_RDOQ | K1_NR)) {
    case K1_RDOQ: k1_lane<CTB, BD, K1_RDOQ | RQT>(s, a, l); break;
    case K1_NR: k1_lane<CTB, BD, K1_NR | RQT>(s, a, l); break;
    case K1_RDOQ | K1_NR: k1_lane<CTB, BD, K1_RDOQ | K1_NR | RQT>(s, a, l); break;
    default: k1_lane<CTB, BD, RQT>(s, a, l);
  }
}

// The host build: the lanes one after another, one thread each.
template <int CTB, int RQT>
static int k1_run(const K1Args& a, void* stream) {
  (void)stream;
  K1Smem* s = (K1Smem*)malloc(sizeof(K1Smem));
  for (int l = 0; l < a.L; ++l) {
    if (a.flags & K1_BD10)
      k1_host_lane<CTB, 10, RQT>(s, a, l);
    else
      k1_host_lane<CTB, 8, RQT>(s, a, l);
  }
  free(s);
  return 0;
}
#endif

// the launches at CTB 32 and 16 (k1_ctb32.cu, k1_ctb16.cu) and those with
// the RQT split (k1_rqt_ctb{64,32,16}.cu)
int k1_run_ctb32(const K1Args& a, void* stream);
int k1_run_ctb16(const K1Args& a, void* stream);
int k1_run_rqt_ctb64(const K1Args& a, void* stream);
int k1_run_rqt_ctb32(const K1Args& a, void* stream);
int k1_run_rqt_ctb16(const K1Args& a, void* stream);
