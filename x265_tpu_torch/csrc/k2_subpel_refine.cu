// K2: subpel motion refinement of 16x16 blocks (8-bit luma).
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
// cost = fma(lam, bits(dy) + bits(dx), satd) with bits from the float32
// mv_bits table and d = mvi * 4 + q - pmv; candidates beyond 4 * mrq qpel
// cost 2^30.  Strict `<` keeps the first of equal costs.
//
// Design: one block of 256 threads per 16x16 block, one thread per
// output pixel.  The window, the source block, the horizontal pass and
// the best prediction stay in shared memory; candidates run one after
// another.  On an H100 the kernel is bound by latency, not bytes: per
// 1080p reference the algorithm reads 8160 x 3.5 KB and needs ~7e8
// integer multiply-adds (counted from the shapes), while each block walks
// 18 dependent candidate stages.

#include "k_common.cuh"

#define K2_N 16
#define K2_WIN 25
#define K2_MVB 1024

__constant__ static const int k2_luma_filters[4][8] = {
    {0, 0, 0, 64, 0, 0, 0, 0},
    {-1, 4, -10, 58, 17, -5, 1, 0},
    {-1, 4, -11, 40, 40, -11, 4, -1},
    {0, 1, -5, 17, 58, -10, 4, -1}};

struct K2Smem {
  int W[K2_WIN * K2_WIN];
  int ob[K2_N * K2_N];
  int tmp[23 * K2_N];
  int pred[K2_N * K2_N];
  int best_pred[K2_N * K2_N];
  int satd;
};

KDEV float k2_bits(const float* mvb, int d) {
  int a = k_abs(d);
  KCHECK(a < K2_MVB);
  return mvb[a];
}

// cost of candidate qpel offset (qy, qx); fills s->pred
KDEV float k2_candidate(K2Smem* s, int qy, int qx, int mvy, int mvx,
                        int pmvy, int pmvx, float lam, const float* mvb,
                        int mrq) {
  const int iy1 = (qy >> 2) + 1, ix1 = (qx >> 2) + 1;
  const int fx = qx & 3, fy = qy & 3;
  for (int i = KTID; i < 23 * K2_N; i += KNTH) {
    const int r = i / K2_N, x = i % K2_N;
    const int* row = s->W + (iy1 + r) * K2_WIN + ix1 + x;
    int acc = 0;
    for (int k = 0; k < 8; ++k) acc += k2_luma_filters[fx][k] * row[k];
    s->tmp[i] = acc;
  }
  if (KTID == 0) s->satd = 0;
  KSYNC();
  for (int i = KTID; i < K2_N * K2_N; i += KNTH) {
    const int y = i / K2_N, x = i % K2_N;
    int acc = 0;
    for (int k = 0; k < 8; ++k)
      acc += k2_luma_filters[fy][k] * s->tmp[(y + k) * K2_N + x];
    s->pred[i] = k_clamp((acc + 2048) >> 12, 0, 255);
  }
  KSYNC();
  for (int b = KTID; b < 16; b += KNTH) {
    const int by = (b >> 2) * 4, bx = (b & 3) * 4;
    int d[4][4], t[4][4];
    for (int y = 0; y < 4; ++y)
      for (int x = 0; x < 4; ++x) {
        const int o = (by + y) * K2_N + bx + x;
        d[y][x] = s->ob[o] - s->pred[o];
      }
    for (int y = 0; y < 4; ++y) {  // rows: H4 along x
      const int s01 = d[y][0] + d[y][1], d01 = d[y][0] - d[y][1];
      const int s23 = d[y][2] + d[y][3], d23 = d[y][2] - d[y][3];
      t[y][0] = s01 + s23; t[y][1] = d01 + d23;
      t[y][2] = s01 - s23; t[y][3] = d01 - d23;
    }
    int sum = 0;
    for (int x = 0; x < 4; ++x) {  // columns: H4 along y
      const int s01 = t[0][x] + t[1][x], d01 = t[0][x] - t[1][x];
      const int s23 = t[2][x] + t[3][x], d23 = t[2][x] - t[3][x];
      sum += k_abs(s01 + s23) + k_abs(d01 + d23) + k_abs(s01 - s23) +
             k_abs(d01 - d23);
    }
    KADD(&s->satd, (sum + 1) >> 1);
  }
  KSYNC();
  const int mqy = mvy * 4 + qy, mqx = mvx * 4 + qx;
  if (k_abs(mqy) > 4 * mrq || k_abs(mqx) > 4 * mrq) return 1073741824.0f;
  const float bits = k2_bits(mvb, mqy - pmvy) + k2_bits(mvb, mqx - pmvx);
  return KFMA(lam, bits, k_i2f(s->satd));
}

KDEV void k2_block(K2Smem* s, int b, const int* W, const int* ob,
                   const int* mvi, const int* pmv, const float* lam_p,
                   const float* mvb, int* q0, int* pred, float* cost,
                   int subme, int mrq) {
  for (int i = KTID; i < K2_WIN * K2_WIN; i += KNTH)
    s->W[i] = W[(int64_t)b * K2_WIN * K2_WIN + i];
  for (int i = KTID; i < K2_N * K2_N; i += KNTH)
    s->ob[i] = ob[(int64_t)b * K2_N * K2_N + i];
  KSYNC();
  const float lam = lam_p[0];
  const int mvy = mvi[2 * b], mvx = mvi[2 * b + 1];
  const int pmvy = pmv[2 * b], pmvx = pmv[2 * b + 1];
  const int steps[2] = {subme == 0 ? 0 : 2, 1};
  const int nrounds = subme >= 2 ? 2 : 1;
  int cy = 0, cx = 0;
  float best = 0.0f;
  for (int r = 0; r < nrounds; ++r) {
    const int step = steps[r];
    const int ncand = step == 0 ? 1 : 9;  // step 0: nine equal candidates
    int by = cy, bx = cx;
    for (int k = 0; k < ncand; ++k) {
      const int qy = cy + (k / 3 - 1) * step, qx = cx + (k % 3 - 1) * step;
      const float c = k2_candidate(s, qy, qx, mvy, mvx, pmvy, pmvx, lam,
                                   mvb, mrq);
      if (k == 0 || c < best) {
        best = c;
        by = qy;
        bx = qx;
        for (int i = KTID; i < K2_N * K2_N; i += KNTH)
          s->best_pred[i] = s->pred[i];
      }
      KSYNC();
    }
    cy = by;
    cx = bx;
  }
  for (int i = KTID; i < K2_N * K2_N; i += KNTH)
    pred[(int64_t)b * K2_N * K2_N + i] = s->best_pred[i];
  if (KTID == 0) {
    q0[2 * b] = cy;
    q0[2 * b + 1] = cx;
    cost[b] = best;
  }
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(256)
    k2_kernel(const int* W, const int* ob, const int* mvi, const int* pmv,
              const float* lam, const float* mvb, int* q0, int* pred,
              float* cost, int subme, int mrq) {
  __shared__ K2Smem s;
  k2_block(&s, blockIdx.x, W, ob, mvi, pmv, lam, mvb, q0, pred, cost, subme,
           mrq);
}

extern "C" int k2_subpel_refine(const int* W, const int* ob, const int* mvi,
                                const int* pmv, const float* lam,
                                const float* mvb, int* q0, int* pred,
                                float* cost, int B, int subme, int mrq,
                                void* stream) {
  if (B > 0)
    k2_kernel<<<B, 256, 0, (cudaStream_t)stream>>>(W, ob, mvi, pmv, lam, mvb,
                                                   q0, pred, cost, subme, mrq);
  return (int)cudaGetLastError();
}
#else
extern "C" int k2_subpel_refine(const int* W, const int* ob, const int* mvi,
                                const int* pmv, const float* lam,
                                const float* mvb, int* q0, int* pred,
                                float* cost, int B, int subme, int mrq,
                                void* stream) {
  (void)stream;
  K2Smem* s = (K2Smem*)malloc(sizeof(K2Smem));
  for (int b = 0; b < B; ++b)
    k2_block(s, b, W, ob, mvi, pmv, lam, mvb, q0, pred, cost, subme, mrq);
  free(s);
  return 0;
}
#endif
