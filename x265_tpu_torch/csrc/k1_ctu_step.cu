// K1: one wavefront level of the CTU reconstruction scan (8-bit, 64x64
// CTBs, 32x32 quads of four 16x16 slots).
//
// Replaces x265_tpu/encoder/ctu_scan_pallas.py make_pallas_step (body
// `kernel` at :494, pallas_call at :927).  Plain version: CtuScan.make_step
// in x265_tpu_torch/encoder/ctu_scan.py; every output of one launch equals
// one call of that step.
//
// One thread block per lane CTU of the level.  The lane's reconstruction
// buffers -- luma C [97][129] and chroma Cc [2][49][65], row 0 / column 0
// seeded from the frontiers -- stay in shared memory for the whole CTU
// (sizeof(K1Smem) = 132,516 bytes with the work buffers, dynamic shared
// memory), and the 4 quads x 4 slots run in z-order inside the block:
//   quad: 32x32 luma intra candidate (strong smoothing), TU32 chain, the
//         16x16 chroma candidates;
//   slot: 16x16 luma prediction (intra mode or the inter prediction), TU16
//         chain, 8x8 chroma prediction and TU8 chains, recon into C / Cc,
//         the 16x16 RD cost (+ psy);
//   quad: cost32 vs cost16, the inter TU32 trial of merged quads, the
//         choice written into C / Cc.
// Angular prediction is the spec formula per pixel; transforms, quant,
// sign hiding and dequant are integer loops.  Float costs round as the
// reference's: SSD and bit counts converted to float32, sums in the
// plain step's order, `lam * bits` and `plam * psy` fused (KFMA), and the
// file is compiled with --fmad=false so nothing else is contracted.
//
// What bounds it on an H100: a level has at most 15 lanes (15 of 132 SMs
// busy), and each block walks ~60 dependent stages separated by barriers,
// so it is latency-bound; the bytes (~60 KB of inputs per lane, counted
// from the shapes) are negligible.

#include "k_common.cuh"

#define K1_INTER 1
#define K1_DECIDE32 2
#define K1_PSY 4
#define K1_SIGN_HIDE 8
#define K1_STRONG 16

#define CH_ 97
#define CW_ 129
#define CHC 49
#define CWC 65

__constant__ static const int k1_angles[33] = {
    32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21, -26, -32,
    -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17, 21, 26, 32};
__constant__ static const int k1_qs[6] = {26214, 23302, 20560,
                                          18396, 16384, 14564};
__constant__ static const int k1_iqs[6] = {40, 45, 51, 57, 64, 72};
// rank of (x, y) in the 4x4 up-right diagonal scan, row-major [y][x]
__constant__ static const int k1_diag4_rank[16] = {0, 2, 5, 9,  1,  4,  8,  12,
                                                   3, 7, 11, 14, 6, 10, 13, 15};

struct K1Args {
  const int *cx, *cy, *m16, *m32, *qp_y, *qp_cb, *qp_cr;
  const int *o16y, *o8c, *o32y, *o16cb, *o16cr;
  const u8 *l16_av, *c8_av, *l32_av, *c16_av, *quad_ok;
  const float *lam, *plam;
  const u8 *use32, *inter;
  const int *ipy, *ipc;
  const u8* m32in;
  const int *rowf, *colf, *cornf, *rowfb, *colfb, *cornfb, *rowfr, *colfr,
      *cornfr;
  int *lv16, *lv8, *lv32, *lvc16, *sel32, *int_y, *int_c;
  int *nrowf, *ncolf, *nrowfb, *ncolfb, *nrowfr, *ncolfr;
  const int* T32;
  int L, cw, ch, flags;
};

struct K1Smem {
  int C[CH_ * CW_];
  int Cc[2 * CHC * CWC];
  int T[1024];
  int r[3][132], rf[3][132];  // substituted / prediction references
  int dc[3];
  int P32[1024], LV32[1024], R32[1024];
  int PC[512], LVC[512], RC[512];
  int IP32[1024], IPC[512];  // the quad's slot predictions, joined
  int LV32I[1024], R32I[1024], LVCI[512], RCI[512];
  int P16[256], LV16[256], R16[256];
  int P8[128], LV8[128], R8[128];
  int wa[1024], wb[1024];
  int acc[8];
  float cost32, cost16;
  int any_inter;
};

// floor division / modulo by 6 (torch semantics for any sign)
KDEV int k1_div6(int q) { return q >= 0 ? q / 6 : -((-q + 5) / 6); }
KDEV int k1_mod6(int q) { return q - 6 * k1_div6(q); }
KDEV int k1_log2(int n) { return n == 8 ? 3 : (n == 16 ? 4 : 5); }

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

// Gather the canonical reference vector of the n x n block at (lx0, ly0)
// of buffer B (row stride `stride`; row/column 0 are the frontier), apply
// the spec substitution with availability `av`, then the reference filter
// or strong smoothing.  One thread.
KDEV void k1_prep_ref(const int* B, int stride, int lx0, int ly0, int n,
                      const u8* av, int* r, int* rf, int* dc, int mode,
                      bool luma, bool strong) {
  const int R = 4 * n + 1;
  int first = -1;
  for (int k = 0; k < R; ++k)
    if (av[k]) {
      first = k;
      break;
    }
#define K1_SAMPLE(k)                                  \
  ((k) <= 2 * n ? B[(ly0 + 2 * n - (k)) * stride + lx0] \
                : B[ly0 * stride + lx0 + 1 + ((k)-2 * n - 1)])
  if (first < 0) {
    for (int k = 0; k < R; ++k) r[k] = 128;
  } else {
    int cur = K1_SAMPLE(first);
    for (int k = 0; k < R; ++k) {
      if (av[k]) cur = K1_SAMPLE(k);
      r[k] = cur;
    }
  }
#undef K1_SAMPLE
  const bool filt = k1_filter_flag(mode, n, luma);
  bool use_strong = false;
  if (luma && n == 32 && strong && filt) {
    const int corner = r[64], bl = r[0], tr = r[128];
    use_strong = k_abs(corner + tr - 2 * r[96]) < 8 &&
                 k_abs(corner + bl - 2 * r[32]) < 8;
    if (use_strong) {
      rf[0] = bl;
      for (int k = 1; k < 64; ++k)
        rf[k] = (k * corner + (64 - k) * bl + 32) >> 6;
      rf[64] = corner;
      for (int j = 0; j < 63; ++j)
        rf[65 + j] = ((63 - j) * corner + (j + 1) * tr + 32) >> 6;
      rf[128] = tr;
    }
  }
  if (!use_strong) {
    if (filt) {
      rf[0] = r[0];
      rf[R - 1] = r[R - 1];
      for (int k = 1; k < R - 1; ++k)
        rf[k] = (r[k - 1] + 2 * r[k] + r[k + 1] + 2) >> 2;
    } else {
      for (int k = 0; k < R; ++k) rf[k] = r[k];
    }
  }
  int s = 0;
  for (int k = 0; k < n; ++k) s += rf[2 * n + 1 + k] + rf[2 * n - 1 - k];
  *dc = (s + n) >> (k1_log2(n) + 1);
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
KDEV int k1_pred_pixel(const int* r, const int* rf, int dc, int mode, int n,
                       int y, int x, bool luma) {
  int v;
  if (mode == 0) {
    const int log2n = k1_log2(n);
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
      v = k_clamp(r[2 * n + 1] + ((r[2 * n - 1 - y] - corner) >> 1), 0, 255);
    } else if (mode == 10 && y == 0) {
      v = k_clamp(r[2 * n - 1] + ((r[2 * n + 1 + x] - corner) >> 1), 0, 255);
    }
  }
  return v;
}

// --- transform / quant chain -------------------------------------------------

KDEV int k1_quant(int c, int qp, bool intra, int log2n) {
  const int qbits = 14 + k1_div6(qp) + (15 - 8 - log2n);
  const int scale = k1_qs[k1_mod6(qp)];
  const int a = k_abs(c);
  const int hi = a * (scale >> 7), lo = a * (scale & 127);
  const int offset = (intra ? 171 : 85) << (qbits - 9);
  const int level = k_clamp((hi + ((lo + offset) >> 7)) >> (qbits - 7), 0,
                            32767);
  return c < 0 ? -level : (c > 0 ? level : 0);
}

KDEV int k1_dequant(int l, int qp, int log2n) {
  const int bd_shift = 8 + log2n - 5;
  const int scale_eff = (k1_iqs[k1_mod6(qp)] * 16) << k1_div6(qp);
  const int lmax = (32767 << bd_shift) / scale_eff + 1;
  const int lv = l > lmax ? lmax : (l < -lmax ? -lmax : l);
  return k_clamp((lv * scale_eff + (1 << (bd_shift - 1))) >> bd_shift, -32768,
                 32767);
}

// Sign-hiding parity fix of one 4x4 group (gy, gx) of an n x n block.
KDEV void k1_sign_hide_group(int* lv, int n, int gy, int gx) {
  int first = 99, last = -1, val = 0, sumabs = 0, fpos = 0;
  for (int y = 0; y < 4; ++y)
    for (int x = 0; x < 4; ++x) {
      const int pos = (gy * 4 + y) * n + gx * 4 + x;
      const int v = lv[pos];
      if (v != 0) {
        const int rk = k1_diag4_rank[y * 4 + x];
        if (rk < first) {
          first = rk;
          val = v;
          fpos = pos;
        }
        if (rk > last) last = rk;
      }
      sumabs += k_abs(v);
    }
  const bool hide = (last - first) > 3;
  const bool odd = (sumabs & 1) == 1;
  if (hide && (odd != (val < 0))) lv[fpos] += val > 0 ? 1 : -1;
}

// nb blocks of n x n: orig[b] (global, contiguous n*n), pred / lv / rec in
// shared memory at b * n * n.  rec = clip(pred + inverse(dequant(lv))).
KDEV void k1_tq(K1Smem* s, int nb, int n, const int* const* orig,
                const int* pred, int* lv, int* rec, const int* qp,
                const bool* intra, bool sign_hide) {
  const int NN = n * n, tot = nb * NN, log2n = k1_log2(n);
  const int step = 32 / n * 32;  // row stride of T_n inside T32
  const int sh1 = log2n - 1, sh2 = log2n + 6;
  const int* T = s->T;
  int* wa = s->wa;
  int* wb = s->wb;
  for (int i = KTID; i < tot; i += KNTH) {
    const int b = i / NN, j = i - b * NN;
    wa[i] = orig[b][j] - pred[i];
  }
  KSYNC();
  for (int i = KTID; i < tot; i += KNTH) {  // rows: s1[k][row]
    const int b = i / NN, rr = i - b * NN, k = rr / n, j = rr - k * n;
    const int* t = T + k * step;
    const int* x = wa + b * NN + j * n;
    int acc = 0;
    for (int m = 0; m < n; ++m) acc += t[m] * x[m];
    wb[i] = (acc + (1 << (sh1 - 1))) >> sh1;
  }
  KSYNC();
  for (int i = KTID; i < tot; i += KNTH) {  // columns, then quant
    const int b = i / NN, rr = i - b * NN, k = rr / n, j = rr - k * n;
    const int* t = T + k * step;
    const int* x = wb + b * NN + j * n;
    int acc = 0;
    for (int m = 0; m < n; ++m) acc += t[m] * x[m];
    lv[i] = k1_quant((acc + (1 << (sh2 - 1))) >> sh2, qp[b], intra[b], log2n);
  }
  KSYNC();
  if (sign_hide) {
    const int g = n / 4, ng = g * g;
    for (int i = KTID; i < nb * ng; i += KNTH) {
      const int b = i / ng, gi = i - b * ng;
      k1_sign_hide_group(lv + b * NN, n, gi / g, gi % g);
    }
    KSYNC();
  }
  for (int i = KTID; i < tot; i += KNTH)
    wa[i] = k1_dequant(lv[i], qp[i / NN], log2n);
  KSYNC();
  for (int i = KTID; i < tot; i += KNTH) {  // inverse columns: e1[y][u]
    const int b = i / NN, rr = i - b * NN, y = rr / n, u = rr - y * n;
    const int* x = wa + b * NN + u;
    int acc = 0;
    for (int v = 0; v < n; ++v) acc += T[v * step + y] * x[v * n];
    wb[i] = k_clamp((acc + 64) >> 7, -32768, 32767);
  }
  KSYNC();
  for (int i = KTID; i < tot; i += KNTH) {  // inverse rows
    const int b = i / NN, rr = i - b * NN, y = rr / n, x = rr - y * n;
    const int* e = wb + b * NN + y * n;
    int acc = 0;
    for (int u = 0; u < n; ++u) acc += T[u * step + x] * e[u];
    const int res = k_clamp((acc + 2048) >> 12, -32768, 32767);
    rec[i] = k_clamp(pred[i] + res, 0, 255);
  }
  KSYNC();
}

// --- RD costs ------------------------------------------------------------------

KDEV int k1_level_bits(int v) {
  const int a = k_abs(v);
  if (a == 0) return 0;
  int msb = 0;
  for (int k = 1; k < 16; ++k) msb += a >= (1 << k);
  return 2 * msb + 3;
}

// AC Hadamard energy of one 8x8 tile (row stride `stride`):
// sa8d(tile, 0) - (sum(tile) >> 2).
KDEV int k1_psy_energy8(const int* p, int stride) {
  int t[8][8];
  int sum = 0;
  for (int y = 0; y < 8; ++y) {
    int a[8];
    for (int x = 0; x < 8; ++x) {
      a[x] = p[y * stride + x];
      sum += a[x];
    }
    int h[8];
    for (int half = 0; half < 2; ++half) {
      const int* q = a + 4 * half;
      const int s01 = q[0] + q[1], d01 = q[0] - q[1];
      const int s23 = q[2] + q[3], d23 = q[2] - q[3];
      h[4 * half + 0] = s01 + s23;
      h[4 * half + 1] = d01 + d23;
      h[4 * half + 2] = s01 - s23;
      h[4 * half + 3] = d01 - d23;
    }
    for (int x = 0; x < 4; ++x) {
      t[y][x] = h[x] + h[4 + x];
      t[y][4 + x] = h[x] - h[4 + x];
    }
  }
  int sa = 0;
  for (int x = 0; x < 8; ++x) {
    int h[8];
    for (int half = 0; half < 2; ++half) {
      const int q0 = t[4 * half][x], q1 = t[4 * half + 1][x];
      const int q2 = t[4 * half + 2][x], q3 = t[4 * half + 3][x];
      const int s01 = q0 + q1, d01 = q0 - q1, s23 = q2 + q3, d23 = q2 - q3;
      h[4 * half + 0] = s01 + s23;
      h[4 * half + 1] = d01 + d23;
      h[4 * half + 2] = s01 - s23;
      h[4 * half + 3] = d01 - d23;
    }
    for (int y = 0; y < 4; ++y)
      sa += k_abs(h[y] + h[4 + y]) + k_abs(h[y] - h[4 + y]);
  }
  return ((sa + 2) >> 2) - (sum >> 2);
}

// SSD + lam * (level bits + ovh) of one luma block (n) and its two chroma
// blocks (n / 2), plus the psy term of the luma block in s->acc[6].
// Returns the cost without psy; all threads get the same value.
KDEV float k1_rd(K1Smem* s, int n, const int* oy, const int* ry,
                 const int* lvy, const int* const* oc, const int* rc,
                 const int* lvc, float ovh, float lam, bool psy) {
  const int nc = n / 2, NN = n * n, NC = nc * nc;
  if (KTID == 0)
    for (int k = 0; k < 8; ++k) s->acc[k] = 0;
  KSYNC();
  int ssd = 0, bits = 0;
  for (int i = KTID; i < NN; i += KNTH) {
    const int d = ry[i] - oy[i];
    ssd += d * d;
    bits += k1_level_bits(lvy[i]);
  }
  KADD(&s->acc[0], ssd);
  KADD(&s->acc[3], bits);
  for (int i = KTID; i < 2 * NC; i += KNTH) {
    const int p = i / NC, j = i - p * NC;
    const int d = rc[i] - oc[p][j];
    KADD(&s->acc[1 + p], d * d);
    KADD(&s->acc[4 + p], k1_level_bits(lvc[i]));
  }
  // coded 4x4 groups: 2 bits each
  const int gy = n / 4, gc = nc / 4;
  for (int i = KTID; i < gy * gy + 2 * gc * gc; i += KNTH) {
    const int* lv;
    int w, g, p;
    if (i < gy * gy) {
      lv = lvy; w = n; g = i; p = -1;
    } else {
      const int k = i - gy * gy;
      p = k / (gc * gc);
      g = k - p * gc * gc;
      lv = lvc + p * NC; w = nc;
    }
    const int gw = w / 4, y0 = (g / gw) * 4, x0 = (g % gw) * 4;
    int nz = 0;
    for (int y = 0; y < 4; ++y)
      for (int x = 0; x < 4; ++x) nz |= lv[(y0 + y) * w + x0 + x] != 0;
    if (nz) KADD(&s->acc[p < 0 ? 3 : 4 + p], 2);
  }
  if (psy) {
    const int t = n / 8;
    for (int i = KTID; i < t * t; i += KNTH) {
      const int y0 = (i / t) * 8, x0 = (i % t) * 8;
      const int eo = k1_psy_energy8(oy + y0 * n + x0, n);
      const int er = k1_psy_energy8(ry + y0 * n + x0, n);
      KADD(&s->acc[6], k_abs(eo - er));
    }
  }
  KSYNC();
  const float fbits = ((k_i2f(s->acc[3]) + k_i2f(s->acc[4])) +
                       k_i2f(s->acc[5])) + ovh;
  const float dist = (k_i2f(s->acc[0]) + k_i2f(s->acc[1])) + k_i2f(s->acc[2]);
  const float cost = KFMA(lam, fbits, dist);
  KSYNC();  // acc is reused by the next call
  return cost;
}

// --- the lane ------------------------------------------------------------------

KDEV void k1_lane(K1Smem* s, const K1Args& a, int l) {
  const int L = a.L;
  const bool inter = a.flags & K1_INTER, decide = a.flags & K1_DECIDE32;
  const bool psy = a.flags & K1_PSY, sh = a.flags & K1_SIGN_HIDE;
  const bool strong = a.flags & K1_STRONG;
  const int cx = a.cx[l], cy = a.cy[l];
  const int cx1 = cx + 1 < a.cw ? cx + 1 : a.cw;
  const int par = (cy - 1) & 1;
  const int qpy = a.qp_y[l];
  const int qpc[2] = {a.qp_cb[l], a.qp_cr[l]};
  const float lam = decide ? a.lam[l] : 0.0f;
  const float plam = psy ? a.plam[l] : 0.0f;
  const int* rowfc[2] = {a.rowfb, a.rowfr};
  const int* colfc[2] = {a.colfb, a.colfr};
  const int* cornfc[2] = {a.cornfb, a.cornfr};

  for (int i = KTID; i < 1024; i += KNTH) s->T[i] = a.T32[i];
  for (int i = KTID; i < CH_ * CW_; i += KNTH) {
    const int y = i / CW_, x = i % CW_;
    int v = 0;
    if (y == 0 && x == 0)
      v = a.cornf[cx * 2 + par];
    else if (y == 0)
      v = x <= 64 ? a.rowf[cx * 64 + x - 1] : a.rowf[cx1 * 64 + x - 65];
    else if (x == 0 && y <= 64)
      v = a.colf[cy * 64 + y - 1];
    s->C[i] = v;
  }
  for (int i = KTID; i < 2 * CHC * CWC; i += KNTH) {
    const int p = i / (CHC * CWC), k = i % (CHC * CWC);
    const int y = k / CWC, x = k % CWC;
    int v = 0;
    if (y == 0 && x == 0)
      v = cornfc[p][cx * 2 + par];
    else if (y == 0)
      v = x <= 32 ? rowfc[p][cx * 32 + x - 1] : rowfc[p][cx1 * 32 + x - 33];
    else if (x == 0 && y <= 32)
      v = colfc[p][cy * 32 + y - 1];
    s->Cc[i] = v;
  }
  KSYNC();

  const bool all_intra[2] = {true, true};
  const bool no_intra[2] = {false, false};

  for (int q = 0; q < 4; ++q) {
    const int qx = (q & 1) * 32, qy = (q >> 1) * 32;
    const int m32 = a.m32[l * 4 + q];
    const int* o32 = a.o32y + (int64_t)(l * 4 + q) * 1024;
    const int* oc32[2] = {a.o16cb + (int64_t)(l * 4 + q) * 256,
                          a.o16cr + (int64_t)(l * 4 + q) * 256};
    // 32x32 intra candidate: luma and both chroma planes
    for (int v = KTID; v < 3; v += KNTH) {
      if (v == 0)
        k1_prep_ref(s->C, CW_, qx, qy, 32, a.l32_av + (l * 4 + q) * 129,
                    s->r[0], s->rf[0], &s->dc[0], m32, true, strong);
      else
        k1_prep_ref(s->Cc + (v - 1) * CHC * CWC, CWC, qx / 2, qy / 2, 16,
                    a.c16_av + (l * 4 + q) * 65, s->r[v], s->rf[v],
                    &s->dc[v], m32, false, false);
    }
    KSYNC();
    for (int i = KTID; i < 1024 + 512; i += KNTH) {
      if (i < 1024)
        s->P32[i] = k1_pred_pixel(s->r[0], s->rf[0], s->dc[0], m32, 32,
                                  i / 32, i % 32, true);
      else {
        const int k = i - 1024, p = k / 256, j = k % 256;
        s->PC[k] = k1_pred_pixel(s->r[1 + p], s->rf[1 + p], s->dc[1 + p], m32,
                                 16, j / 16, j % 16, false);
      }
    }
    KSYNC();
    const int* o32p[1] = {o32};
    k1_tq(s, 1, 32, o32p, s->P32, s->LV32, s->R32, &qpy, all_intra, sh);
    k1_tq(s, 2, 16, oc32, s->PC, s->LVC, s->RC, qpc, all_intra, sh);
    if (decide) {
      float c32 = k1_rd(s, 32, o32, s->R32, s->LV32, oc32, s->RC, s->LVC,
                        12.0f, lam, psy);
      if (psy) c32 = KFMA(plam, k_i2f(s->acc[6]), c32);
      if (KTID == 0) {
        s->cost32 = c32;
        s->cost16 = 0.0f;
        s->any_inter = 0;
      }
    }
    KSYNC();

    for (int sl = 0; sl < 4; ++sl) {
      const int i = q * 4 + sl;
      const int ox = (sl & 1) * 16, oy = (sl >> 1) * 16;
      const int sx = qx + ox, sy = qy + oy;
      const int m = a.m16[l * 16 + i];
      const bool iv = inter && a.inter[l * 16 + i];
      const int* o16 = a.o16y + (int64_t)(l * 16 + i) * 256;
      const int* oc8[2] = {a.o8c + (int64_t)((l * 16 + i) * 2) * 64,
                           a.o8c + (int64_t)((l * 16 + i) * 2 + 1) * 64};
      if (!iv) {
        for (int v = KTID; v < 3; v += KNTH) {
          if (v == 0)
            k1_prep_ref(s->C, CW_, sx, sy, 16, a.l16_av + (l * 16 + i) * 65,
                        s->r[0], s->rf[0], &s->dc[0], m, true, false);
          else
            k1_prep_ref(s->Cc + (v - 1) * CHC * CWC, CWC, sx / 2, sy / 2, 8,
                        a.c8_av + (l * 16 + i) * 33, s->r[v], s->rf[v],
                        &s->dc[v], m, false, false);
        }
        KSYNC();
      }
      for (int k = KTID; k < 256 + 128; k += KNTH) {
        if (k < 256) {
          const int y = k / 16, x = k % 16;
          const int v = iv ? a.ipy[(int64_t)(l * 16 + i) * 256 + k]
                           : k1_pred_pixel(s->r[0], s->rf[0], s->dc[0], m, 16,
                                           y, x, true);
          s->P16[k] = v;
          s->IP32[(oy + y) * 32 + ox + x] = v;
        } else {
          const int kk = k - 256, p = kk / 64, j = kk % 64, y = j / 8,
                    x = j % 8;
          const int v =
              iv ? a.ipc[(int64_t)((l * 16 + i) * 2 + p) * 64 + j]
                 : k1_pred_pixel(s->r[1 + p], s->rf[1 + p], s->dc[1 + p], m,
                                 8, y, x, false);
          s->P8[kk] = v;
          s->IPC[p * 256 + (oy / 2 + y) * 16 + ox / 2 + x] = v;
        }
      }
      KSYNC();
      const bool intra1[1] = {!iv};
      const bool intra2[2] = {!iv, !iv};
      const int* o16p[1] = {o16};
      k1_tq(s, 1, 16, o16p, s->P16, s->LV16, s->R16, &qpy, intra1, sh);
      k1_tq(s, 2, 8, oc8, s->P8, s->LV8, s->R8, qpc, intra2, sh);
      for (int k = KTID; k < 256 + 128; k += KNTH) {
        if (k < 256) {
          a.lv16[(int64_t)(i * L + l) * 256 + k] = s->LV16[k];
          s->C[(1 + sy + k / 16) * CW_ + 1 + sx + k % 16] = s->R16[k];
        } else {
          const int kk = k - 256, p = kk / 64, j = kk % 64;
          a.lv8[(int64_t)(i * 2 * L + p * L + l) * 64 + j] = s->LV8[kk];
          s->Cc[p * CHC * CWC + (1 + sy / 2 + j / 8) * CWC + 1 + sx / 2 +
                j % 8] = s->R8[kk];
        }
      }
      KSYNC();
      if (decide) {
        const float c = k1_rd(s, 16, o16, s->R16, s->LV16, oc8, s->R8,
                              s->LV8, 9.0f, lam, psy);
        float c16 = s->cost16 + c;
        if (psy) c16 = KFMA(plam, k_i2f(s->acc[6]), c16);
        KSYNC();
        if (KTID == 0) {
          s->cost16 = c16;
          s->any_inter |= iv;
        }
        KSYNC();
      }
    }

    bool u32;
    if (decide) {
      u32 = a.quad_ok[l * 4 + q] && (s->cost32 < s->cost16);
      if (inter) u32 = u32 && !s->any_inter;
    } else {
      u32 = a.use32[l * 4 + q];
    }
    bool tu32 = false;
    if (inter && decide && a.m32in[l * 4 + q]) {
      const int* o32p[1] = {o32};
      k1_tq(s, 1, 32, o32p, s->IP32, s->LV32I, s->R32I, &qpy, no_intra, sh);
      k1_tq(s, 2, 16, oc32, s->IPC, s->LVCI, s->RCI, qpc, no_intra, sh);
      float ci = k1_rd(s, 32, o32, s->R32I, s->LV32I, oc32, s->RCI, s->LVCI,
                       12.0f, lam, psy);
      if (psy) ci = KFMA(plam, k_i2f(s->acc[6]), ci);
      tu32 = ci < s->cost16;
    }
    const bool sel = u32 || tu32;
    const int* lvf = tu32 ? s->LV32I : s->LV32;
    const int* recf = tu32 ? s->R32I : s->R32;
    const int* lvcf = tu32 ? s->LVCI : s->LVC;
    const int* reccf = tu32 ? s->RCI : s->RC;
    for (int k = KTID; k < 1024 + 512; k += KNTH) {
      if (k < 1024) {
        a.lv32[(int64_t)(q * L + l) * 1024 + k] = lvf[k];
        if (sel) s->C[(1 + qy + k / 32) * CW_ + 1 + qx + k % 32] = recf[k];
      } else {
        const int kk = k - 1024, p = kk / 256, j = kk % 256;
        a.lvc16[(int64_t)(q * 2 * L + p * L + l) * 256 + j] = lvcf[kk];
        if (sel)
          s->Cc[p * CHC * CWC + (1 + qy / 2 + j / 16) * CWC + 1 + qx / 2 +
                j % 16] = reccf[kk];
      }
    }
    if (KTID == 0) a.sel32[q * L + l] = sel;
    KSYNC();
  }

  // outputs: the CTU's tiles and the new frontiers
  for (int k = KTID; k < 4096; k += KNTH)
    a.int_y[(int64_t)l * 4096 + k] = s->C[(1 + k / 64) * CW_ + 1 + k % 64];
  for (int k = KTID; k < 2048; k += KNTH) {
    const int p = k / 1024, j = k % 1024;
    a.int_c[(int64_t)(p * L + l) * 1024 + j] =
        s->Cc[p * CHC * CWC + (1 + j / 32) * CWC + 1 + j % 32];
  }
  for (int k = KTID; k < 64; k += KNTH) {
    a.nrowf[cx * 64 + k] = s->C[64 * CW_ + 1 + k];
    a.ncolf[cy * 64 + k] = s->C[(1 + k) * CW_ + 64];
  }
  int* nrowc[2] = {a.nrowfb, a.nrowfr};
  int* ncolc[2] = {a.ncolfb, a.ncolfr};
  for (int k = KTID; k < 64; k += KNTH) {
    const int p = k / 32, j = k % 32;
    nrowc[p][cx * 32 + j] = s->Cc[p * CHC * CWC + 32 * CWC + 1 + j];
    ncolc[p][cy * 32 + j] = s->Cc[p * CHC * CWC + (1 + j) * CWC + 32];
  }
}

static void k1_unpack(K1Args* a, void* const* p, int L, int cw, int ch,
                      int flags) {
  int k = 0;
#define NEXT(T) ((T)p[k++])
  a->cx = NEXT(const int*); a->cy = NEXT(const int*);
  a->m16 = NEXT(const int*); a->m32 = NEXT(const int*);
  a->qp_y = NEXT(const int*); a->qp_cb = NEXT(const int*);
  a->qp_cr = NEXT(const int*);
  a->o16y = NEXT(const int*); a->o8c = NEXT(const int*);
  a->o32y = NEXT(const int*); a->o16cb = NEXT(const int*);
  a->o16cr = NEXT(const int*);
  a->l16_av = NEXT(const u8*); a->c8_av = NEXT(const u8*);
  a->l32_av = NEXT(const u8*); a->c16_av = NEXT(const u8*);
  a->quad_ok = NEXT(const u8*);
  a->lam = NEXT(const float*); a->plam = NEXT(const float*);
  a->use32 = NEXT(const u8*); a->inter = NEXT(const u8*);
  a->ipy = NEXT(const int*); a->ipc = NEXT(const int*);
  a->m32in = NEXT(const u8*);
  a->rowf = NEXT(const int*); a->colf = NEXT(const int*);
  a->cornf = NEXT(const int*); a->rowfb = NEXT(const int*);
  a->colfb = NEXT(const int*); a->cornfb = NEXT(const int*);
  a->rowfr = NEXT(const int*); a->colfr = NEXT(const int*);
  a->cornfr = NEXT(const int*);
  a->lv16 = NEXT(int*); a->lv8 = NEXT(int*); a->lv32 = NEXT(int*);
  a->lvc16 = NEXT(int*); a->sel32 = NEXT(int*); a->int_y = NEXT(int*);
  a->int_c = NEXT(int*);
  a->nrowf = NEXT(int*); a->ncolf = NEXT(int*); a->nrowfb = NEXT(int*);
  a->ncolfb = NEXT(int*); a->nrowfr = NEXT(int*); a->ncolfr = NEXT(int*);
  a->T32 = NEXT(const int*);
#undef NEXT
  a->L = L; a->cw = cw; a->ch = ch; a->flags = flags;
}

#define K1_NPTRS 47

#ifdef __CUDACC__
__global__ void __launch_bounds__(256) k1_kernel(K1Args a) {
  extern __shared__ int k1_smem[];
  k1_lane((K1Smem*)k1_smem, a, blockIdx.x);
}

extern "C" int k1_ctu_step(void* const* p, int np, int L, int cw, int ch,
                           int flags, void* stream) {
  if (np != K1_NPTRS) return -1;
  K1Args a;
  k1_unpack(&a, p, L, cw, ch, flags);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        k1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)sizeof(K1Smem));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  k1_kernel<<<L, 256, sizeof(K1Smem), (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int k1_smem_bytes() { return (int)sizeof(K1Smem); }
#else
extern "C" int k1_ctu_step(void* const* p, int np, int L, int cw, int ch,
                           int flags, void* stream) {
  (void)stream;
  if (np != K1_NPTRS) return -1;
  K1Args a;
  k1_unpack(&a, p, L, cw, ch, flags);
  K1Smem* s = (K1Smem*)malloc(sizeof(K1Smem));
  for (int l = 0; l < L; ++l) k1_lane(s, a, l);
  free(s);
  return 0;
}

extern "C" int k1_smem_bytes() { return (int)sizeof(K1Smem); }
#endif
