/* Native CABAC slice-data encoder, merge/AMVP/skip derivation and input
 * dithering of x265_tpu_torch, copied from x265_tpu/native/slice_enc.c.
 * The slice encoder also writes cu_transquant_bypass_flag (lossless), which
 * the reference writes with its Python CABAC only.
 *
 * Role: the sequential entropy-coding pass (the one irreducibly serial
 * component of HEVC) runs as native code on the host while the pixel work
 * runs on the GPU.  Its output bytes are those of the reference's Python
 * CABAC (x265_tpu/cabac/{engine,syntax,ctu}.py), which
 * tests/test_native_entropy.py asserts for the original.
 *
 * Spec: ITU-T H.265 §7.3.8 (syntax), §9.3 (CABAC).  Reference embodiment
 * of the role: x265_1.9/source/encoder/entropy.cpp (encodeCTU).
 *
 * Toolset: I and P slices (2Nx2N inter PUs, single ref L0).
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* ---- context layout: must match cabac/tables.py CTX_OFFSET ---- */
enum {
    CTX_SAO_MERGE = 0,
    CTX_SAO_TYPE_IDX = 1,
    CTX_SPLIT_CU = 2,
    CTX_CU_TRANSQUANT_BYPASS = 5,
    CTX_CU_SKIP = 6,
    CTX_PRED_MODE = 9,
    CTX_PART_MODE = 10,
    CTX_PREV_INTRA_LUMA = 14,
    CTX_INTRA_CHROMA = 15,
    CTX_CBF_LUMA = 16,
    CTX_CBF_CHROMA = 18,
    CTX_SPLIT_TRANSFORM = 22,
    CTX_LAST_X_PREFIX = 25,
    CTX_LAST_Y_PREFIX = 43,
    CTX_CODED_SUB_BLOCK = 61,
    CTX_SIG_COEFF = 65,
    CTX_GREATER1 = 107,
    CTX_GREATER2 = 131,
    CTX_MERGE_FLAG = 137,
    CTX_MERGE_IDX = 138,
    CTX_INTER_PRED_IDC = 139,
    CTX_REF_IDX = 144,
    CTX_MVD_GREATER = 146,
    CTX_MVP_FLAG = 148,
    CTX_RQT_ROOT_CBF = 149,
    CTX_CU_QP_DELTA = 150,
    NUM_CTX_EXPECT = 154,
};

/* Table 9-46 rangeTabLps */
static const uint8_t LPS_TABLE[64][4] = {
    {128,176,208,240},{128,167,197,227},{128,158,187,216},{123,150,178,205},
    {116,142,169,195},{111,135,160,185},{105,128,152,175},{100,122,144,166},
    {95,116,137,158},{90,110,130,150},{85,104,123,142},{81,99,117,135},
    {77,94,111,128},{73,89,105,122},{69,85,100,116},{66,80,95,110},
    {62,76,90,104},{59,72,86,99},{56,69,81,94},{53,65,77,89},
    {51,62,73,85},{48,59,69,80},{46,56,66,76},{43,53,63,72},
    {41,50,59,69},{39,48,56,65},{37,45,54,62},{35,43,51,59},
    {33,41,48,56},{32,39,46,53},{30,37,43,50},{29,35,41,48},
    {27,33,39,45},{26,31,37,43},{24,30,35,41},{23,28,33,39},
    {22,27,32,37},{21,26,30,35},{20,24,29,33},{19,23,27,31},
    {18,22,26,30},{17,21,25,28},{16,20,23,27},{15,19,22,25},
    {14,18,21,24},{14,17,20,23},{13,16,19,22},{12,15,18,21},
    {12,14,17,20},{11,14,16,19},{11,13,15,18},{10,12,15,17},
    {10,12,14,16},{9,11,13,15},{9,11,12,14},{8,10,12,14},
    {8,9,11,13},{7,9,11,12},{7,9,10,12},{7,8,10,11},
    {6,8,9,11},{6,7,9,10},{6,7,8,9},{2,2,2,2},
};
static const uint8_t NEXT_MPS[64] = {
    1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,17,18,19,20,21,22,23,24,25,26,
    27,28,29,30,31,32,33,34,35,36,37,38,39,40,41,42,43,44,45,46,47,48,49,
    50,51,52,53,54,55,56,57,58,59,60,61,62,62,63};
static const uint8_t NEXT_LPS[64] = {
    0,0,1,2,2,4,4,5,6,7,8,9,9,11,11,12,13,13,15,15,16,16,18,18,19,19,21,
    21,22,22,23,24,24,25,26,26,27,27,28,29,29,30,30,30,31,32,32,33,33,33,
    34,34,35,35,35,36,36,36,37,37,37,38,38,63};

static const uint8_t CTX_IDX_MAP_4x4[16] =
    {0,1,4,5,2,3,4,5,6,6,8,8,7,7,8,8};
static const uint8_t MIN_IN_GROUP[10] = {0,1,2,3,4,6,8,12,16,24};
static const uint8_t GROUP_IDX[32] =
    {0,1,2,3,4,4,5,5,6,6,6,6,7,7,7,7,8,8,8,8,8,8,8,8,9,9,9,9,9,9,9,9};

#define SCAN_DIAG 0
#define SCAN_HORIZ 1
#define SCAN_VERT 2
#define MODE_PLANAR 0
#define MODE_DC 1
#define MODE_HOR 10
#define MODE_VER 26

/* ---- scan tables (built once) ---- */
/* scan_xy[scan][log2-1][i] packs (x | y<<8) for a size=2^log2.. we need
 * scan orders for group grids (1,2,4,8) and the inner 4x4. */
static int scan_built = 0;
static uint16_t scan_tab[3][4][64];   /* [scan][log2 of size 1/2/4/8][64] */

static void build_scan_for(int scan, int size, uint16_t *out) {
    int i = 0, x, y, s;
    if (scan == SCAN_DIAG) {
        for (s = 0; s <= 2 * (size - 1); s++)
            for (x = 0; x <= s; x++) {
                y = s - x;
                if (x < size && y < size) out[i++] = (uint16_t)(x | (y << 8));
            }
    } else if (scan == SCAN_HORIZ) {
        for (y = 0; y < size; y++) for (x = 0; x < size; x++)
            out[i++] = (uint16_t)(x | (y << 8));
    } else {
        for (x = 0; x < size; x++) for (y = 0; y < size; y++)
            out[i++] = (uint16_t)(x | (y << 8));
    }
}

static void build_scans(void) {
    int sc, l;
    if (scan_built) return;
    for (sc = 0; sc < 3; sc++)
        for (l = 0; l < 4; l++)
            build_scan_for(sc, 1 << l, scan_tab[sc][l]);
    scan_built = 1;
}

/* ---- encoder state ---- */
typedef struct {
    /* bit writer */
    uint8_t *out;
    long cap, pos;          /* byte position */
    uint32_t cur;           /* partial byte bits (MSB-aligned count=bitpos) */
    int bitpos;
    int overflow;
    /* cabac */
    uint32_t low, range, bits_outstanding;
    int first_bit;
    uint8_t ctx[NUM_CTX_EXPECT];
    /* picture */
    const uint8_t *depth, *part, *luma_mode, *chroma_mode, *tu_depth;
    const uint8_t *skip, *merge_flag, *merge_idx, *mvp_flag;
    const uint8_t *pred_mode_arr;
    const uint8_t *inter_dir, *mvp_flag1, *ref_idx0, *ref_idx1;
    const int8_t *sao_type, *sao_eo_class, *sao_band_pos, *sao_offsets;
    int sao_luma, sao_chroma, bit_depth;
    int ctbs_w;
    const int16_t *mvd, *mvd1;
    const int32_t *cy, *ccb, *ccr;
    const int64_t *zscan;
    int w, h, w4, h4, ystride, cstride;
    int log2_ctb, min_cb, min_tb, max_tb, max_tr_intra, max_tr_inter;
    int sign_hide, slice_type, max_merge;  /* slice_type: 2=I, 1=P, 0=B */
    int num_ref_l0, num_ref_l1, mvd_l1_zero;
    /* cu_qp_delta (QG == CTB): per-CTB actual QPs + qPY_PREV chain */
    const int32_t *qp_ctb;
    int cu_qp_delta_on, qp_pred, qp_delta_pending, cur_ctu;
    /* lossless: cu_transquant_bypass_flag leads every CU */
    const uint8_t *tq_bypass;
    int transquant_bypass;
} Enc;

/* ---- bit output ---- */
static void put_bits(Enc *e, uint32_t val, int n) {
    if (n == 0) return;
    uint64_t acc = ((uint64_t)e->cur << n) | val;
    int total = e->bitpos + n;
    while (total >= 8) {
        total -= 8;
        if (e->pos >= e->cap) { e->overflow = 1; return; }
        e->out[e->pos++] = (uint8_t)((acc >> total) & 0xFF);
    }
    e->cur = (uint32_t)(acc & ((1u << total) - 1));
    e->bitpos = total;
}

static void put_bit_cabac(Enc *e, int b) {
    if (e->first_bit) e->first_bit = 0;
    else put_bits(e, (uint32_t)b, 1);
    if (e->bits_outstanding) {
        uint32_t inv = (uint32_t)(1 - b);
        while (e->bits_outstanding) { put_bits(e, inv, 1); e->bits_outstanding--; }
    }
}

static void renorm(Enc *e) {
    while (e->range < 256) {
        if (e->low >= 0x200) { put_bit_cabac(e, 1); e->low -= 0x200; }
        else if (e->low < 0x100) put_bit_cabac(e, 0);
        else { e->low -= 0x100; e->bits_outstanding++; }
        e->range <<= 1;
        e->low <<= 1;
    }
}

static void encode_bin(Enc *e, int ctx_idx, int binval) {
    uint8_t packed = e->ctx[ctx_idx];
    int state = packed >> 1, mps = packed & 1;
    uint32_t lps = LPS_TABLE[state][(e->range >> 6) & 3];
    e->range -= lps;
    if (binval != mps) {
        e->low += e->range;
        e->range = lps;
        if (state == 0) mps = 1 - mps;
        state = NEXT_LPS[state];
    } else {
        state = NEXT_MPS[state];
    }
    e->ctx[ctx_idx] = (uint8_t)((state << 1) | mps);
    renorm(e);
}

static void encode_bypass(Enc *e, int binval) {
    e->low <<= 1;
    if (binval) e->low += e->range;
    if (e->low >= 0x400) { put_bit_cabac(e, 1); e->low -= 0x400; }
    else if (e->low < 0x200) put_bit_cabac(e, 0);
    else { e->low -= 0x200; e->bits_outstanding++; }
}

static void encode_bypass_bins(Enc *e, uint32_t value, int n) {
    int i;
    for (i = n - 1; i >= 0; i--) encode_bypass(e, (value >> i) & 1);
}

static void cabac_flush(Enc *e) {
    e->range = 2;
    renorm(e);
    put_bit_cabac(e, (e->low >> 9) & 1);
    put_bits(e, ((e->low >> 7) & 3) | 1, 2);
}

static void encode_terminate(Enc *e, int binval) {
    e->range -= 2;
    if (binval) { e->low += e->range; cabac_flush(e); }
    else renorm(e);
}

/* ---- availability / MPM ---- */
static int avail(const Enc *e, int xc, int yc, int xn, int yn) {
    if (xn < 0 || yn < 0 || xn >= e->w || yn >= e->h) return 0;
    return e->zscan[(yn >> 2) * e->w4 + (xn >> 2)]
         < e->zscan[(yc >> 2) * e->w4 + (xc >> 2)];
}

static void luma_mpm(const Enc *e, int x0, int y0, int mpm[3]) {
    int cand[2], i;
    for (i = 0; i < 2; i++) {
        int xn = i == 0 ? x0 - 1 : x0;
        int yn = i == 0 ? y0 : y0 - 1;
        int mode = MODE_DC;
        if (avail(e, x0, y0, xn, yn)
            && e->pred_mode_arr[(yn >> 2) * e->w4 + (xn >> 2)] == 1) {
            /* above neighbor outside the current CTB row -> DC */
            if (!(i == 1 && (yn >> e->log2_ctb) != (y0 >> e->log2_ctb)))
                mode = e->luma_mode[(yn >> 2) * e->w4 + (xn >> 2)];
        }
        cand[i] = mode;
    }
    if (cand[0] == cand[1]) {
        if (cand[0] < 2) { mpm[0] = MODE_PLANAR; mpm[1] = MODE_DC; mpm[2] = MODE_VER; }
        else {
            mpm[0] = cand[0];
            mpm[1] = 2 + ((cand[0] + 29) % 32);
            mpm[2] = 2 + ((cand[0] - 2 + 1) % 32);
        }
    } else {
        mpm[0] = cand[0]; mpm[1] = cand[1];
        if (cand[0] != MODE_PLANAR && cand[1] != MODE_PLANAR) mpm[2] = MODE_PLANAR;
        else if (cand[0] != MODE_DC && cand[1] != MODE_DC) mpm[2] = MODE_DC;
        else mpm[2] = MODE_VER;
    }
}

static int scan_for_intra(int log2_size, int c_idx, int mode) {
    if (log2_size == 2 || (log2_size == 3 && c_idx == 0)) {
        if (mode >= 6 && mode <= 14) return SCAN_VERT;
        if (mode >= 22 && mode <= 30) return SCAN_HORIZ;
    }
    return SCAN_DIAG;
}

/* ---- residual coding ---- */
static int sig_ctx(int x, int y, int log2_size, int c_idx, int scan_idx,
                   int csbf_right, int csbf_below) {
    int sig;
    if (log2_size == 2) sig = CTX_IDX_MAP_4x4[(y << 2) + x];
    else if (x + y == 0) sig = 0;
    else {
        int prev = csbf_right + 2 * csbf_below;
        int xp = x & 3, yp = y & 3;
        if (prev == 0) sig = (xp + yp == 0) ? 2 : (xp + yp < 3 ? 1 : 0);
        else if (prev == 1) sig = (yp == 0) ? 2 : (yp == 1 ? 1 : 0);
        else if (prev == 2) sig = (xp == 0) ? 2 : (xp == 1 ? 1 : 0);
        else sig = 2;
        if (c_idx == 0) {
            if ((x >> 2) + (y >> 2) > 0) sig += 3;
            sig += (log2_size == 3) ? (scan_idx == SCAN_DIAG ? 9 : 15) : 21;
        } else sig += (log2_size == 3) ? 9 : 12;
    }
    return c_idx == 0 ? sig : 27 + sig;
}

static void encode_last_xy(Enc *e, int last_x, int last_y, int log2_size,
                           int c_idx) {
    int offset, shift, cmax, gx, gy, i;
    if (c_idx == 0) {
        offset = 3 * (log2_size - 2) + ((log2_size - 1) >> 2);
        shift = (log2_size + 1) >> 2;
    } else { offset = 15; shift = log2_size - 2; }
    cmax = (log2_size << 1) - 1;
    gx = GROUP_IDX[last_x]; gy = GROUP_IDX[last_y];
    for (i = 0; i < gx; i++)
        encode_bin(e, CTX_LAST_X_PREFIX + offset + (i >> shift), 1);
    if (gx < cmax) encode_bin(e, CTX_LAST_X_PREFIX + offset + (gx >> shift), 0);
    for (i = 0; i < gy; i++)
        encode_bin(e, CTX_LAST_Y_PREFIX + offset + (i >> shift), 1);
    if (gy < cmax) encode_bin(e, CTX_LAST_Y_PREFIX + offset + (gy >> shift), 0);
    if (gx > 3) encode_bypass_bins(e, (uint32_t)(last_x - MIN_IN_GROUP[gx]), (gx >> 1) - 1);
    if (gy > 3) encode_bypass_bins(e, (uint32_t)(last_y - MIN_IN_GROUP[gy]), (gy >> 1) - 1);
}

static void encode_remaining(Enc *e, int value, int rice) {
    if ((value >> rice) < 4) {
        int prefix = value >> rice, i;
        for (i = 0; i < prefix; i++) encode_bypass(e, 1);
        encode_bypass(e, 0);
        if (rice) encode_bypass_bins(e, (uint32_t)(value & ((1 << rice) - 1)), rice);
    } else {
        int m = 1, i;
        while (value >= (((1 << (m + 1)) + 2) << rice)) m++;
        for (i = 0; i < 3 + m; i++) encode_bypass(e, 1);
        encode_bypass(e, 0);
        encode_bypass_bins(e, (uint32_t)(value - (((1 << m) + 2) << rice)), m + rice);
    }
}

/* coeffs: pointer to top-left of TB in its plane, with given stride */
static void encode_residual(Enc *e, const int32_t *coeffs, int stride,
                            int log2_size, int c_idx, int scan_idx) {
    int size = 1 << log2_size;
    int ngd = size >> 2; if (ngd < 1) ngd = 1;
    const uint16_t *sb_scan = scan_tab[scan_idx][log2_size - 2];
    const uint16_t *coef_scan = scan_tab[scan_idx][2];

    /* last position in hierarchical scan */
    int last_scan_idx = -1, i, n;
    int nsb = ngd * ngd;
    for (i = nsb - 1; i >= 0 && last_scan_idx < 0; i--) {
        int xs = sb_scan[i] & 0xFF, ys = sb_scan[i] >> 8;
        for (n = 15; n >= 0; n--) {
            int xc = xs * 4 + (coef_scan[n] & 0xFF);
            int yc = ys * 4 + (coef_scan[n] >> 8);
            if (coeffs[yc * stride + xc]) { last_scan_idx = i * 16 + n; break; }
        }
    }
    if (last_scan_idx < 0) return;   /* caller guarantees nonzero */

    {
    int last_sb = last_scan_idx >> 4;
    int last_pos_in_sb = last_scan_idx & 15;
    int lx = sb_scan[last_sb] & 0xFF, ly = sb_scan[last_sb] >> 8;
    int last_x = lx * 4 + (coef_scan[last_pos_in_sb] & 0xFF);
    int last_y = ly * 4 + (coef_scan[last_pos_in_sb] >> 8);
    uint8_t csbf[8][8];
    int xs, ys, prev_c1 = 1;

    memset(csbf, 0, sizeof(csbf));
    for (ys = 0; ys < ngd; ys++)
        for (xs = 0; xs < ngd; xs++) {
            int yy, xx, nz = 0;
            for (yy = 0; yy < 4 && !nz; yy++)
                for (xx = 0; xx < 4; xx++)
                    if (coeffs[(ys * 4 + yy) * stride + xs * 4 + xx]) { nz = 1; break; }
            csbf[ys][xs] = (uint8_t)nz;
        }
    csbf[sb_scan[0] >> 8][sb_scan[0] & 0xFF] = 1;

    if (scan_idx == SCAN_VERT) { int t = last_x; last_x = last_y; last_y = t; }
    encode_last_xy(e, last_x, last_y, log2_size, c_idx);

    for (i = last_sb; i >= 0; i--) {
        int xg = sb_scan[i] & 0xFF, yg = sb_scan[i] >> 8;
        int infer_dc_sig = 0;
        int csbf_right = (xg + 1 < ngd) ? csbf[yg][xg + 1] : 0;
        int csbf_below = (yg + 1 < ngd) ? csbf[yg + 1][xg] : 0;
        int sig_pos[16], nsig = 0;
        int start;

        if (i < last_sb && i > 0) {
            int ctx = CTX_CODED_SUB_BLOCK + (c_idx ? 2 : 0)
                    + ((csbf_right || csbf_below) ? 1 : 0);
            encode_bin(e, ctx, csbf[yg][xg]);
            infer_dc_sig = 1;
        }
        if (!csbf[yg][xg]) continue;

        start = (i == last_sb) ? last_pos_in_sb - 1 : 15;
        if (i == last_sb) sig_pos[nsig++] = last_pos_in_sb;
        for (n = start; n >= 0; n--) {
            int xc = xg * 4 + (coef_scan[n] & 0xFF);
            int yc = yg * 4 + (coef_scan[n] >> 8);
            int sig = coeffs[yc * stride + xc] != 0;
            if (n > 0 || !infer_dc_sig) {
                int ctx = CTX_SIG_COEFF + sig_ctx(xc, yc, log2_size, c_idx,
                                                  scan_idx, csbf_right, csbf_below);
                encode_bin(e, ctx, sig);
                if (sig) infer_dc_sig = 0;
            }
            if (sig) sig_pos[nsig++] = n;
        }
        if (!nsig) continue;

        {
        int levels[16], abs_levels[16], k;
        int ctx_set, c1 = 1, first_g2 = -1, hidden, rice = 0;
        int first_sig_scan, last_sig_scan;

        for (k = 0; k < nsig; k++) {
            int xc = xg * 4 + (coef_scan[sig_pos[k]] & 0xFF);
            int yc = yg * 4 + (coef_scan[sig_pos[k]] >> 8);
            levels[k] = coeffs[yc * stride + xc];
            abs_levels[k] = levels[k] < 0 ? -levels[k] : levels[k];
        }
        ctx_set = (i > 0 && c_idx == 0) ? 2 : 0;
        if (prev_c1 == 0) ctx_set += 1;
        for (k = 0; k < nsig && k < 8; k++) {
            int g1 = abs_levels[k] > 1;
            int ctx = CTX_GREATER1 + (c_idx ? 16 : 0) + ctx_set * 4 + c1;
            encode_bin(e, ctx, g1);
            if (g1) { c1 = 0; if (first_g2 < 0) first_g2 = k; }
            else if (c1 > 0 && c1 < 3) c1++;
        }
        if (first_g2 >= 0)
            encode_bin(e, CTX_GREATER2 + (c_idx ? 4 : 0) + ctx_set,
                       abs_levels[first_g2] > 2);
        prev_c1 = c1;

        first_sig_scan = sig_pos[nsig - 1];
        last_sig_scan = sig_pos[0];
        hidden = e->sign_hide && (last_sig_scan - first_sig_scan > 3);
        for (k = 0; k < nsig; k++) {
            if (hidden && k == nsig - 1) continue;
            encode_bypass(e, levels[k] < 0);
        }
        for (k = 0; k < nsig; k++) {
            int base = (k < 8) ? (2 + (k == first_g2)) : 1;
            if (abs_levels[k] >= base) {
                encode_remaining(e, abs_levels[k] - base, rice);
                if (abs_levels[k] > (3 << rice) && rice < 4) rice++;
            }
        }
        }
    }
    }
}

/* ---- cbf helpers: any-nonzero over a square region ---- */
static int region_nz(const int32_t *plane, int stride, int x, int y, int sz) {
    int yy, xx;
    for (yy = 0; yy < sz; yy++)
        for (xx = 0; xx < sz; xx++)
            if (plane[(y + yy) * stride + x + xx]) return 1;
    return 0;
}

/* ---- transform tree ---- */
static void enc_eg_k(Enc *e, int value, int k);

/* cu_qp_delta_abs (TR prefix cMax 5 + EG0 suffix) + sign (9.3.3.8) */
static void enc_cu_qp_delta(Enc *e, int delta) {
    int a = delta < 0 ? -delta : delta, k;
    encode_bin(e, CTX_CU_QP_DELTA, a > 0);
    if (a > 0) {
        for (k = 1; k < (a < 5 ? a : 5); k++)
            encode_bin(e, CTX_CU_QP_DELTA + 1, 1);
        if (a < 5) encode_bin(e, CTX_CU_QP_DELTA + 1, 0);
        else enc_eg_k(e, a - 5, 0);
        encode_bypass(e, delta < 0);
    }
}

static void enc_transform_unit(Enc *e, int x0, int y0, int xb, int yb,
                               int log2_size, int blk_idx, int cbf_luma,
                               int cbf_cb, int cbf_cr, int is_intra) {
    int size = 1 << log2_size;
    int cx, cy, clog2, csz, cmode, cscan;
    if (!(cbf_luma || cbf_cb || cbf_cr)) return;
    if (e->qp_delta_pending) {
        enc_cu_qp_delta(e, e->qp_ctb[e->cur_ctu] - e->qp_pred);
        e->qp_delta_pending = 0;
    }
    if (cbf_luma) {
        int mode = e->luma_mode[(y0 >> 2) * e->w4 + (x0 >> 2)];
        int scan = is_intra ? scan_for_intra(log2_size, 0, mode) : SCAN_DIAG;
        encode_residual(e, e->cy + y0 * e->ystride + x0, e->ystride,
                        log2_size, 0, scan);
    }
    (void)size;
    if (log2_size > 2) { cx = x0 >> 1; cy = y0 >> 1; clog2 = log2_size - 1; }
    else if (blk_idx == 3) { cx = xb >> 1; cy = yb >> 1; clog2 = 2; }
    else return;
    csz = 1 << clog2; (void)csz;
    cmode = e->chroma_mode[((cy * 2) >> 2) * e->w4 + ((cx * 2) >> 2)];
    cscan = is_intra ? scan_for_intra(clog2, 1, cmode) : SCAN_DIAG;
    if (cbf_cb)
        encode_residual(e, e->ccb + cy * e->cstride + cx, e->cstride,
                        clog2, 1, cscan);
    if (cbf_cr)
        encode_residual(e, e->ccr + cy * e->cstride + cx, e->cstride,
                        clog2, 2, cscan);
}

static void enc_transform_tree(Enc *e, int x0, int y0, int xb, int yb,
                               int log2_size, int depth, int blk_idx,
                               int intra_split, int is_intra) {
    int tu_depth_here = e->tu_depth[(y0 >> 2) * e->w4 + (x0 >> 2)];
    int split = tu_depth_here > depth;
    int max_depth = (is_intra ? e->max_tr_intra : e->max_tr_inter)
                    + (intra_split ? 1 : 0);
    int size = 1 << log2_size;
    int csize = size >> 1;
    int cbf_cb, cbf_cr;

    if (log2_size <= e->max_tb && log2_size > e->min_tb
        && depth < max_depth && !(intra_split && depth == 0))
        encode_bin(e, CTX_SPLIT_TRANSFORM + 5 - log2_size, split);

    if (log2_size > 2) {
        int parent_cb = depth == 0
            || region_nz(e->ccb, e->cstride, xb >> 1, yb >> 1, size);
        int parent_cr = depth == 0
            || region_nz(e->ccr, e->cstride, xb >> 1, yb >> 1, size);
        cbf_cb = region_nz(e->ccb, e->cstride, x0 >> 1, y0 >> 1, csize);
        cbf_cr = region_nz(e->ccr, e->cstride, x0 >> 1, y0 >> 1, csize);
        if (parent_cb) encode_bin(e, CTX_CBF_CHROMA + depth, cbf_cb);
        if (parent_cr) encode_bin(e, CTX_CBF_CHROMA + depth, cbf_cr);
    } else {
        cbf_cb = region_nz(e->ccb, e->cstride, xb >> 1, yb >> 1, size);
        cbf_cr = region_nz(e->ccr, e->cstride, xb >> 1, yb >> 1, size);
    }

    if (split) {
        int half = size >> 1, i;
        for (i = 0; i < 4; i++)
            enc_transform_tree(e, x0 + (i & 1) * half, y0 + (i >> 1) * half,
                               x0, y0, log2_size - 1, depth + 1, i,
                               intra_split, is_intra);
        return;
    }
    {
    int cbf_luma = region_nz(e->cy, e->ystride, x0, y0, size);
    if (is_intra || depth != 0 || cbf_cb || cbf_cr)
        encode_bin(e, CTX_CBF_LUMA + (depth == 0 ? 1 : 0), cbf_luma);
    enc_transform_unit(e, x0, y0, xb, yb, log2_size, blk_idx,
                       cbf_luma, cbf_cb, cbf_cr, is_intra);
    }
}

/* ---- inter syntax helpers ---- */
static int skip_ctx(const Enc *e, int x0, int y0) {
    int ctx = 0;
    if (avail(e, x0, y0, x0 - 1, y0)
        && e->skip[(y0 >> 2) * e->w4 + ((x0 - 1) >> 2)]) ctx++;
    if (avail(e, x0, y0, x0, y0 - 1)
        && e->skip[((y0 - 1) >> 2) * e->w4 + (x0 >> 2)]) ctx++;
    return CTX_CU_SKIP + ctx;
}

static void enc_merge_idx(Enc *e, int idx) {
    int cmax = e->max_merge - 1, k;
    if (cmax == 0) return;
    encode_bin(e, CTX_MERGE_IDX, idx > 0 ? 1 : 0);
    if (idx > 0) {
        for (k = 1; k < idx; k++) encode_bypass(e, 1);
        if (idx < cmax) encode_bypass(e, 0);
    }
}

static void enc_eg_k(Enc *e, int value, int k) {
    while (value >= (1 << k)) {
        encode_bypass(e, 1);
        value -= 1 << k;
        k += 1;
    }
    encode_bypass(e, 0);
    encode_bypass_bins(e, (uint32_t)value, k);
}

static void enc_mvd(Enc *e, int mvd_x, int mvd_y) {
    int ax = mvd_x < 0 ? -mvd_x : mvd_x;
    int ay = mvd_y < 0 ? -mvd_y : mvd_y;
    encode_bin(e, CTX_MVD_GREATER, ax > 0);
    encode_bin(e, CTX_MVD_GREATER, ay > 0);
    if (ax > 0) encode_bin(e, CTX_MVD_GREATER + 1, ax > 1);
    if (ay > 0) encode_bin(e, CTX_MVD_GREATER + 1, ay > 1);
    if (ax > 0) {
        if (ax > 1) enc_eg_k(e, ax - 2, 1);
        encode_bypass(e, mvd_x < 0);
    }
    if (ay > 0) {
        if (ay > 1) enc_eg_k(e, ay - 2, 1);
        encode_bypass(e, mvd_y < 0);
    }
}

static void enc_intra_cu(Enc *e, int x0, int y0, int log2_size);

/* ref_idx_lX: TR binarization, cMax = num-1 (§9.3.3.2, Table 9-37) */
static void enc_ref_idx(Enc *e, int idx, int num) {
    int cmax = num - 1, k;
    if (num <= 1) return;
    encode_bin(e, CTX_REF_IDX, idx > 0);
    if (idx > 0 && cmax > 1) {
        encode_bin(e, CTX_REF_IDX + 1, idx > 1);
        for (k = 2; k < idx; k++) encode_bypass(e, 1);
        if (idx > 1 && idx < cmax) encode_bypass(e, 0);
    }
}

/* ---- CU / quadtree ---- */
static void enc_cu(Enc *e, int x0, int y0, int log2_size) {
    int y4 = y0 >> 2, x4 = x0 >> 2;
    int size = 1 << log2_size;
    if (e->transquant_bypass)   /* §7.3.8.5: leads the coding_unit */
        encode_bin(e, CTX_CU_TRANSQUANT_BYPASS, e->tq_bypass[y4 * e->w4 + x4]);
    if (e->slice_type != 2) {       /* P/B slice */
        int skip = e->skip[y4 * e->w4 + x4];
        encode_bin(e, skip_ctx(e, x0, y0), skip);
        if (skip) {
            enc_merge_idx(e, e->merge_idx[y4 * e->w4 + x4]);
            return;
        }
        {
        int isintra = e->pred_mode_arr[y4 * e->w4 + x4] == 1;
        encode_bin(e, CTX_PRED_MODE, isintra);
        if (!isintra) {
            int merge = e->merge_flag[y4 * e->w4 + x4];
            int root_cbf;
            encode_bin(e, CTX_PART_MODE, 1);   /* 2Nx2N */
            encode_bin(e, CTX_MERGE_FLAG, merge);
            if (merge) {
                enc_merge_idx(e, e->merge_idx[y4 * e->w4 + x4]);
            } else {
                int d = e->inter_dir ? e->inter_dir[y4 * e->w4 + x4] : 1;
                if (d == 0) d = 1;
                if (e->slice_type == 0) {     /* B: inter_pred_idc */
                    int dep = e->depth[y4 * e->w4 + x4];
                    encode_bin(e, CTX_INTER_PRED_IDC + dep, d == 3);
                    if (d != 3)
                        encode_bin(e, CTX_INTER_PRED_IDC + 4, d == 2);
                }
                if (d & 1) {
                    enc_ref_idx(e, e->ref_idx0 ?
                                e->ref_idx0[y4 * e->w4 + x4] : 0,
                                e->num_ref_l0);
                    enc_mvd(e, e->mvd[(y4 * e->w4 + x4) * 2],
                            e->mvd[(y4 * e->w4 + x4) * 2 + 1]);
                    encode_bin(e, CTX_MVP_FLAG,
                               e->mvp_flag[y4 * e->w4 + x4]);
                }
                if (d & 2) {
                    enc_ref_idx(e, e->ref_idx1 ?
                                e->ref_idx1[y4 * e->w4 + x4] : 0,
                                e->num_ref_l1);
                    if (!(e->mvd_l1_zero && d == 3))
                        enc_mvd(e, e->mvd1[(y4 * e->w4 + x4) * 2],
                                e->mvd1[(y4 * e->w4 + x4) * 2 + 1]);
                    encode_bin(e, CTX_MVP_FLAG,
                               e->mvp_flag1[y4 * e->w4 + x4]);
                }
            }
            root_cbf = region_nz(e->cy, e->ystride, x0, y0, size)
                || region_nz(e->ccb, e->cstride, x0 >> 1, y0 >> 1, size >> 1)
                || region_nz(e->ccr, e->cstride, x0 >> 1, y0 >> 1, size >> 1);
            if (!merge) encode_bin(e, CTX_RQT_ROOT_CBF, root_cbf);
            if (root_cbf)
                enc_transform_tree(e, x0, y0, x0, y0, log2_size, 0, 0, 0, 0);
            return;
        }
        }
    }
    enc_intra_cu(e, x0, y0, log2_size);
}

static void enc_intra_cu(Enc *e, int x0, int y0, int log2_size) {
    int nxn = e->part[(y0 >> 2) * e->w4 + (x0 >> 2)] != 0;
    int size = 1 << log2_size;
    int pb = nxn ? size >> 1 : size;
    int pus[4][2];
    int npu = nxn ? 4 : 1;
    int infos_mode[4], infos_mpm[4][3], infos_in[4];
    int i, j;

    if (log2_size == e->min_cb)
        encode_bin(e, CTX_PART_MODE, nxn ? 0 : 1);

    pus[0][0] = x0; pus[0][1] = y0;
    if (nxn) {
        pus[1][0] = x0 + pb; pus[1][1] = y0;
        pus[2][0] = x0;      pus[2][1] = y0 + pb;
        pus[3][0] = x0 + pb; pus[3][1] = y0 + pb;
    }
    for (i = 0; i < npu; i++) {
        int mode = e->luma_mode[(pus[i][1] >> 2) * e->w4 + (pus[i][0] >> 2)];
        int in_mpm = 0;
        luma_mpm(e, pus[i][0], pus[i][1], infos_mpm[i]);
        for (j = 0; j < 3; j++) if (infos_mpm[i][j] == mode) in_mpm = 1;
        infos_mode[i] = mode;
        infos_in[i] = in_mpm;
        encode_bin(e, CTX_PREV_INTRA_LUMA, in_mpm);
    }
    for (i = 0; i < npu; i++) {
        if (infos_in[i]) {
            int idx = 0;
            for (j = 0; j < 3; j++) if (infos_mpm[i][j] == infos_mode[i]) { idx = j; break; }
            encode_bypass(e, idx > 0);
            if (idx) encode_bypass(e, idx - 1);
        } else {
            int rem = infos_mode[i];
            int srt[3];
            for (j = 0; j < 3; j++) srt[j] = infos_mpm[i][j];
            /* sort descending, subtract */
            for (j = 0; j < 2; j++) {
                int k2;
                for (k2 = j + 1; k2 < 3; k2++)
                    if (srt[k2] > srt[j]) { int t = srt[j]; srt[j] = srt[k2]; srt[k2] = t; }
            }
            for (j = 0; j < 3; j++) if (infos_mode[i] > srt[j]) rem -= 1;
            encode_bypass_bins(e, (uint32_t)rem, 5);
        }
    }
    {
    int luma0 = e->luma_mode[(y0 >> 2) * e->w4 + (x0 >> 2)];
    int cmode = e->chroma_mode[(y0 >> 2) * e->w4 + (x0 >> 2)];
    int cidx, lst[4];
    static const int base_list[4] = {MODE_PLANAR, MODE_VER, MODE_HOR, MODE_DC};
    if (cmode == luma0) cidx = 4;
    else {
        for (i = 0; i < 4; i++)
            lst[i] = (base_list[i] == luma0) ? 34 : base_list[i];
        cidx = 0;
        for (i = 0; i < 4; i++) if (lst[i] == cmode) { cidx = i; break; }
    }
    if (cidx == 4) encode_bin(e, CTX_INTRA_CHROMA, 0);
    else { encode_bin(e, CTX_INTRA_CHROMA, 1); encode_bypass_bins(e, (uint32_t)cidx, 2); }
    }
    enc_transform_tree(e, x0, y0, x0, y0, log2_size, 0, 0, nxn, 1);
}

static void enc_quadtree(Enc *e, int x0, int y0, int log2_size, int depth) {
    int size = 1 << log2_size;
    int fits = (x0 + size <= e->w) && (y0 + size <= e->h);
    int split = (e->depth[(y0 >> 2) * e->w4 + (x0 >> 2)] > depth) || !fits;
    if (fits && log2_size > e->min_cb) {
        int ctx = 0;
        if (avail(e, x0, y0, x0 - 1, y0)
            && e->depth[(y0 >> 2) * e->w4 + ((x0 - 1) >> 2)] > depth) ctx++;
        if (avail(e, x0, y0, x0, y0 - 1)
            && e->depth[((y0 - 1) >> 2) * e->w4 + (x0 >> 2)] > depth) ctx++;
        encode_bin(e, CTX_SPLIT_CU + ctx, split);
    }
    if (split) {
        int half = size >> 1, i;
        for (i = 0; i < 4; i++) {
            int x1 = x0 + (i & 1) * half, y1 = y0 + (i >> 1) * half;
            if (x1 < e->w && y1 < e->h)
                enc_quadtree(e, x1, y1, log2_size - 1, depth + 1);
        }
    } else enc_cu(e, x0, y0, log2_size);
}

/* ---- SAO per-CTB syntax (mirrors cabac/ctu.py _enc_sao) ---- */
static void enc_sao(Enc *e, int ctu_addr) {
    int rx = ctu_addr % e->ctbs_w, ry = ctu_addr / e->ctbs_w;
    int cmax = (1 << ((e->bit_depth < 10 ? e->bit_depth : 10) - 5)) - 1;
    int c_idx, i, k;
    if (rx > 0) encode_bin(e, CTX_SAO_MERGE, 0);
    if (ry > 0) encode_bin(e, CTX_SAO_MERGE, 0);
    for (c_idx = 0; c_idx < 3; c_idx++) {
        int plane_sel = (c_idx == 0) ? 0 : 1;
        int t;
        const int8_t *offs;
        if (c_idx == 0 && !e->sao_luma) continue;
        if (c_idx > 0 && !e->sao_chroma) continue;
        t = e->sao_type[ctu_addr * 2 + plane_sel];
        if (c_idx < 2) {
            if (t == 0) { encode_bin(e, CTX_SAO_TYPE_IDX, 0); }
            else {
                encode_bin(e, CTX_SAO_TYPE_IDX, 1);
                encode_bypass(e, t == 2 ? 1 : 0);
            }
        }
        if (t == 0) continue;
        offs = e->sao_offsets + (ctu_addr * 3 + c_idx) * 4;
        for (i = 0; i < 4; i++) {
            int v = offs[i] < 0 ? -offs[i] : offs[i];
            for (k = 0; k < v; k++) encode_bypass(e, 1);
            if (v < cmax) encode_bypass(e, 0);
        }
        if (t == 1) {
            for (i = 0; i < 4; i++)
                if (offs[i] != 0) encode_bypass(e, offs[i] < 0 ? 1 : 0);
            encode_bypass_bins(
                e, (uint32_t)e->sao_band_pos[ctu_addr * 3 + c_idx], 5);
        } else if (c_idx < 2) {
            encode_bypass_bins(
                e, (uint32_t)e->sao_eo_class[ctu_addr * 2 + plane_sel], 2);
        }
    }
}

/* ---- entry point ---- */
long encode_slice_data(
    const uint8_t *depth, const uint8_t *part, const uint8_t *luma_mode,
    const uint8_t *chroma_mode, const uint8_t *tu_depth,
    const uint8_t *pred_mode, const uint8_t *skip, const uint8_t *merge_flag,
    const uint8_t *merge_idx, const uint8_t *mvp_flag,
    const uint8_t *inter_dir, const uint8_t *mvp_flag1,
    const uint8_t *ref_idx0, const uint8_t *ref_idx1,
    const int16_t *mvd, const int16_t *mvd1,
    const int32_t *coeff_y, const int32_t *coeff_cb, const int32_t *coeff_cr,
    const int64_t *zscan,
    const int8_t *sao_type, const int8_t *sao_eo_class,
    const int8_t *sao_band_pos, const int8_t *sao_offsets,
    int sao_luma, int sao_chroma, int bit_depth,
    int width, int height, int w4, int h4,
    int log2_ctb, int log2_min_cb, int log2_min_tb, int log2_max_tb,
    int max_tr_depth_intra, int max_tr_depth_inter, int sign_hiding,
    int slice_type, int max_merge,
    int num_ref_l0, int num_ref_l1, int mvd_l1_zero,
    const int32_t *qp_ctb, int slice_qp, int cu_qp_delta_on,
    const uint8_t *tq_bypass, int transquant_bypass,
    const uint8_t *ctx_init, int num_ctx,
    uint8_t *out, long out_cap)
{
    Enc e;
    int ctb_size, ctbs_w, ctbs_h, n_ctbs, ctu;

    if (num_ctx != NUM_CTX_EXPECT) return -2;
    build_scans();
    memset(&e, 0, sizeof(e));
    e.out = out; e.cap = out_cap;
    e.low = 0; e.range = 510; e.first_bit = 1;
    memcpy(e.ctx, ctx_init, NUM_CTX_EXPECT);
    e.depth = depth; e.part = part; e.luma_mode = luma_mode;
    e.chroma_mode = chroma_mode; e.tu_depth = tu_depth;
    e.pred_mode_arr = pred_mode; e.skip = skip; e.merge_flag = merge_flag;
    e.merge_idx = merge_idx; e.mvp_flag = mvp_flag; e.mvd = mvd;
    e.inter_dir = inter_dir; e.mvp_flag1 = mvp_flag1;
    e.ref_idx0 = ref_idx0; e.ref_idx1 = ref_idx1; e.mvd1 = mvd1;
    e.num_ref_l0 = num_ref_l0; e.num_ref_l1 = num_ref_l1;
    e.mvd_l1_zero = mvd_l1_zero;
    e.cy = coeff_y; e.ccb = coeff_cb; e.ccr = coeff_cr;
    e.zscan = zscan;
    e.w = width; e.h = height; e.w4 = w4; e.h4 = h4;
    e.ystride = w4 * 4; e.cstride = w4 * 2;
    e.log2_ctb = log2_ctb; e.min_cb = log2_min_cb; e.min_tb = log2_min_tb;
    e.max_tb = log2_max_tb; e.max_tr_intra = max_tr_depth_intra;
    e.max_tr_inter = max_tr_depth_inter;
    e.sign_hide = sign_hiding; e.slice_type = slice_type;
    e.max_merge = max_merge;
    e.sao_type = sao_type; e.sao_eo_class = sao_eo_class;
    e.sao_band_pos = sao_band_pos; e.sao_offsets = sao_offsets;
    e.sao_luma = sao_luma; e.sao_chroma = sao_chroma;
    e.bit_depth = bit_depth;
    e.qp_ctb = qp_ctb; e.cu_qp_delta_on = cu_qp_delta_on;
    e.qp_pred = slice_qp; e.qp_delta_pending = 0; e.cur_ctu = 0;
    e.tq_bypass = tq_bypass; e.transquant_bypass = transquant_bypass;

    ctb_size = 1 << log2_ctb;
    ctbs_w = (width + ctb_size - 1) >> log2_ctb;
    ctbs_h = (height + ctb_size - 1) >> log2_ctb;
    n_ctbs = ctbs_w * ctbs_h;

    e.ctbs_w = ctbs_w;
    for (ctu = 0; ctu < n_ctbs; ctu++) {
        int x0 = (ctu % ctbs_w) << log2_ctb;
        int y0 = (ctu / ctbs_w) << log2_ctb;
        if (sao_luma || sao_chroma) enc_sao(&e, ctu);
        e.cur_ctu = ctu;
        e.qp_delta_pending = e.cu_qp_delta_on;
        enc_quadtree(&e, x0, y0, log2_ctb, 0);
        if (e.cu_qp_delta_on) e.qp_pred = e.qp_ctb[ctu];
        encode_terminate(&e, ctu == n_ctbs - 1 ? 1 : 0);
        if (e.overflow) return -1;
    }
    /* finishSlice: stop bit + align (entropy.h:153 semantics) */
    put_bits(&e, 1, 1);
    if (e.bitpos) put_bits(&e, 0, 8 - e.bitpos);
    if (e.overflow) return -1;
    return e.pos;
}

/* ====================================================================
 * Inter syntax derivation: merge candidate list + AMVP + skip flags.
 *
 * Native port of x265_tpu/common/motion.py (merge_candidates /
 * amvp_candidates — NORMATIVE, §8.5.3.2.3-8) and the per-CU chooser in
 * encoder/intra_encoder.py (_derive_inter_syntax/_derive_skip).  Must
 * match the Python derivation exactly (asserted by tests).
 * Reference embodiment: x265_1.9/source/common/cudata.cpp
 * getInterMergeCandidates / fillMvpCand.
 * ==================================================================== */

typedef struct {
    int dir;                   /* 1=L0, 2=L1, 3=bi */
    int mv0x, mv0y, ref0;
    int mv1x, mv1y, ref1;
} MC;

typedef struct {
    const uint8_t *depth, *pred_mode, *inter_dir, *ref_idx0, *ref_idx1;
    const int16_t *mv0, *mv1;
    const int32_t *cy, *ccb, *ccr;
    const int64_t *zscan;
    int w, h, w4, h4, ystride, cstride, min_cb, max_merge;
    int cur_poc;
    const int32_t *ref_pocs_l0, *ref_pocs_l1;
    int n_ref_l0, n_ref_l1;
    /* TMVP (§8.5.3.2.9): collocated picture's motion field, or tmvp=0 */
    int tmvp, log2_ctb, col_poc;
    const uint8_t *col_pred, *col_dir;
    const int16_t *col_mv0, *col_mv1;
    const int32_t *col_poc0, *col_poc1;
    uint8_t *merge_flag, *merge_idx, *mvp_flag, *mvp_flag1, *skip;
    int16_t *mvd, *mvd1;
} Der;

static int d_avail(const Der *c, int xc, int yc, int xn, int yn) {
    if (xn < 0 || yn < 0 || xn >= c->w || yn >= c->h) return 0;
    return c->zscan[(yn >> 2) * c->w4 + (xn >> 2)]
         < c->zscan[(yc >> 2) * c->w4 + (xc >> 2)];
}

/* full motion at a neighbor position; 0 if unavailable or intra */
static int nbr_motion(const Der *c, int xc, int yc, int xn, int yn, MC *m) {
    int y4, x4, d;
    if (!d_avail(c, xc, yc, xn, yn)) return 0;
    y4 = yn >> 2; x4 = xn >> 2;
    if (c->pred_mode[y4 * c->w4 + x4] == 1) return 0;    /* MODE_INTRA */
    d = c->inter_dir ? c->inter_dir[y4 * c->w4 + x4] : 0;
    if (d == 0) d = 1;         /* legacy P-only state */
    m->dir = d;
    m->mv0x = c->mv0[(y4 * c->w4 + x4) * 2];
    m->mv0y = c->mv0[(y4 * c->w4 + x4) * 2 + 1];
    m->ref0 = c->ref_idx0 ? c->ref_idx0[y4 * c->w4 + x4] : 0;
    m->mv1x = c->mv1 ? c->mv1[(y4 * c->w4 + x4) * 2] : 0;
    m->mv1y = c->mv1 ? c->mv1[(y4 * c->w4 + x4) * 2 + 1] : 0;
    m->ref1 = c->ref_idx1 ? c->ref_idx1[y4 * c->w4 + x4] : 0;
    return 1;
}

/* §8.5.3.2.3 pruning comparison (MotionCand.key() semantics: only the
 * lists named by dir participate) */
static int mc_eq(const MC *a, const MC *b) {
    if (a->dir != b->dir) return 0;
    if ((a->dir & 1) && (a->mv0x != b->mv0x || a->mv0y != b->mv0y
                         || a->ref0 != b->ref0)) return 0;
    if ((a->dir & 2) && (a->mv1x != b->mv1x || a->mv1y != b->mv1y
                         || a->ref1 != b->ref1)) return 0;
    return 1;
}

static int d_temporal_mv(const Der *c, int x0, int y0, int w, int h,
                         int lx, int ref_idx, int out[2]);

/* §8.5.3.2.3-5: spatial A1 B1 B0 A0 (B2) + temporal + combined bi +
 * zero fill */
static int d_merge_candidates(const Der *c, int x0, int y0, int w, int h,
                              MC *out /* [max_merge] */) {
    MC a1, b1, b0, a0, b2;
    int has_a1, has_b1, has_b0, has_a0;
    int n = 0, is_b, num_refs, zero_idx;
    int max_cand = c->max_merge;

    has_a1 = nbr_motion(c, x0, y0, x0 - 1, y0 + h - 1, &a1);
    has_b1 = nbr_motion(c, x0, y0, x0 + w - 1, y0 - 1, &b1);
    has_b0 = nbr_motion(c, x0, y0, x0 + w, y0 - 1, &b0);
    has_a0 = nbr_motion(c, x0, y0, x0 - 1, y0 + h, &a0);
    if (has_a1) out[n++] = a1;
    if (has_b1 && (!has_a1 || !mc_eq(&b1, &a1))) out[n++] = b1;
    if (has_b0 && (!has_b1 || !mc_eq(&b0, &b1))) out[n++] = b0;
    if (has_a0 && (!has_a1 || !mc_eq(&a0, &a1))) out[n++] = a0;
    if (n < 4) {
        if (nbr_motion(c, x0, y0, x0 - 1, y0 - 1, &b2)
            && (!has_a1 || !mc_eq(&b2, &a1))
            && (!has_b1 || !mc_eq(&b2, &b1)))
            out[n++] = b2;
    }
    if (n > max_cand) n = max_cand;

    is_b = c->n_ref_l1 > 0;
    if (n < max_cand && c->tmvp) {
        /* temporal candidate: refIdx 0 per used list, never pruned */
        int m0[2], m1[2], g0, g1;
        g0 = d_temporal_mv(c, x0, y0, w, h, 0, 0, m0);
        g1 = is_b ? d_temporal_mv(c, x0, y0, w, h, 1, 0, m1) : 0;
        if (g0 || g1) {
            out[n].dir = (g0 ? 1 : 0) | (g1 ? 2 : 0);
            out[n].mv0x = g0 ? m0[0] : 0; out[n].mv0y = g0 ? m0[1] : 0;
            out[n].ref0 = 0;
            out[n].mv1x = g1 ? m1[0] : 0; out[n].mv1y = g1 ? m1[1] : 0;
            out[n].ref1 = 0;
            n++;
        }
    }
    if (is_b && n > 1 && n < max_cand) {
        /* §8.5.3.2.4 combined bi-predictive candidates */
        static const int L0IDX[12] = {0,1,0,2,1,2,0,3,1,3,2,3};
        static const int L1IDX[12] = {1,0,2,0,2,1,3,0,3,1,3,2};
        int n_orig = n, comb;
        for (comb = 0; comb < n_orig * (n_orig - 1); comb++) {
            const MC *c0 = &out[L0IDX[comb]], *c1 = &out[L1IDX[comb]];
            int rp0, rp1;
            if (!((c0->dir & 1) && (c1->dir & 2))) continue;
            rp0 = c->ref_pocs_l0[c0->ref0];
            rp1 = c->ref_pocs_l1[c1->ref1];
            if (rp0 == rp1 && c0->mv0x == c1->mv1x && c0->mv0y == c1->mv1y)
                continue;
            out[n].dir = 3;
            out[n].mv0x = c0->mv0x; out[n].mv0y = c0->mv0y;
            out[n].ref0 = c0->ref0;
            out[n].mv1x = c1->mv1x; out[n].mv1y = c1->mv1y;
            out[n].ref1 = c1->ref1;
            n++;
            if (n == max_cand) break;
        }
    }

    /* §8.5.3.2.5 zero candidates */
    num_refs = is_b ? (c->n_ref_l0 < c->n_ref_l1 ? c->n_ref_l0
                                                 : c->n_ref_l1)
                    : c->n_ref_l0;
    zero_idx = 0;
    while (n < max_cand) {
        int r = zero_idx < num_refs ? zero_idx : 0;
        out[n].dir = is_b ? 3 : 1;
        out[n].mv0x = 0; out[n].mv0y = 0; out[n].ref0 = r;
        out[n].mv1x = 0; out[n].mv1y = 0; out[n].ref1 = r;
        n++;
        zero_idx++;
    }
    return n;
}

/* §8.5.3.2.8 MV scaling */
static void d_scale_mv(int mvx, int mvy, int tb, int td, int *out) {
    int tx, dsf, i, m[2];
    if (td == tb) { out[0] = mvx; out[1] = mvy; return; }
    tb = tb < -128 ? -128 : (tb > 127 ? 127 : tb);
    td = td < -128 ? -128 : (td > 127 ? 127 : td);
    if (td > 0) tx = (16384 + (td >> 1)) / td;
    else tx = -((16384 + ((-td) >> 1)) / -td);
    dsf = (tb * tx + 32) >> 6;
    dsf = dsf < -4096 ? -4096 : (dsf > 4095 ? 4095 : dsf);
    m[0] = mvx; m[1] = mvy;
    for (i = 0; i < 2; i++) {
        long v = (long)dsf * m[i];
        long a = ((v < 0 ? -v : v) + 127) >> 8;
        long r = v >= 0 ? a : -a;
        out[i] = r < -32768 ? -32768 : (r > 32767 ? 32767 : (int)r);
    }
}

/* ---- TMVP (§8.5.3.1.7 / 8.5.3.2.9); twin of motion.py temporal_mv */

typedef struct { int dir, mv0x, mv0y, poc0, mv1x, mv1y, poc1; } ColM;

static int d_col_at(const Der *c, int xc, int yc, ColM *m) {
    int y4, x4, i;
    if (!c->tmvp) return 0;
    if (xc >= c->w || yc >= c->h) return 0;
    y4 = (yc & ~15) >> 2; x4 = (xc & ~15) >> 2;
    i = y4 * c->w4 + x4;
    if (c->col_pred[i] == 1) return 0;              /* MODE_INTRA */
    m->dir = c->col_dir[i]; if (!m->dir) m->dir = 1;
    m->mv0x = c->col_mv0[i * 2]; m->mv0y = c->col_mv0[i * 2 + 1];
    m->mv1x = c->col_mv1[i * 2]; m->mv1y = c->col_mv1[i * 2 + 1];
    m->poc0 = c->col_poc0[i]; m->poc1 = c->col_poc1[i];
    return 1;
}

static int d_col_mv(const Der *c, const ColM *m, int lx, int ref_idx,
                    int out[2]) {
    int mvx, mvy, rp, target, col_dist, cur_dist;
    if (m->dir == 2)      { mvx = m->mv1x; mvy = m->mv1y; rp = m->poc1; }
    else if (m->dir == 1) { mvx = m->mv0x; mvy = m->mv0y; rp = m->poc0; }
    else {
        int all_before = 1, i, n;
        for (i = 0; i < c->n_ref_l0 && all_before; i++)
            if (c->ref_pocs_l0[i] > c->cur_poc) all_before = 0;
        for (i = 0; i < c->n_ref_l1 && all_before; i++)
            if (c->ref_pocs_l1[i] > c->cur_poc) all_before = 0;
        n = all_before ? lx : 0;    /* collocated_from_l0 == 1 */
        if (n == 0) { mvx = m->mv0x; mvy = m->mv0y; rp = m->poc0; }
        else        { mvx = m->mv1x; mvy = m->mv1y; rp = m->poc1; }
    }
    target = (lx == 0 ? c->ref_pocs_l0 : c->ref_pocs_l1)[ref_idx];
    col_dist = c->col_poc - rp;
    cur_dist = c->cur_poc - target;
    if (col_dist == cur_dist) { out[0] = mvx; out[1] = mvy; }
    else d_scale_mv(mvx, mvy, cur_dist, col_dist, out);
    return 1;
}

static int d_temporal_mv(const Der *c, int x0, int y0, int w, int h,
                         int lx, int ref_idx, int out[2]) {
    ColM m; int got = 0;
    if (!c->tmvp) return 0;
    if ((y0 >> c->log2_ctb) == ((y0 + h) >> c->log2_ctb))
        got = d_col_at(c, x0 + w, y0 + h, &m);
    if (!got) got = d_col_at(c, x0 + (w >> 1), y0 + (h >> 1), &m);
    if (!got) return 0;
    return d_col_mv(c, &m, lx, ref_idx, out);
}

/* §8.5.3.2.7: AMVP from a neighbor's motion (same list first, then the
 * other; identical reference required unless scaled) */
static int d_amvp_from(const Der *c, const MC *cand, int lx, int ref_idx,
                       int scaled, int *out_mv) {
    int target_poc = (lx == 0 ? c->ref_pocs_l0 : c->ref_pocs_l1)[ref_idx];
    int t;
    for (t = 0; t < 2; t++) {
        int ly = t == 0 ? lx : 1 - lx;
        int mvx, mvy, ref, nb_poc, npocs;
        const int32_t *pocs;
        if (!(cand->dir & (1 << ly))) continue;
        mvx = ly == 0 ? cand->mv0x : cand->mv1x;
        mvy = ly == 0 ? cand->mv0y : cand->mv1y;
        ref = ly == 0 ? cand->ref0 : cand->ref1;
        pocs = ly == 0 ? c->ref_pocs_l0 : c->ref_pocs_l1;
        npocs = ly == 0 ? c->n_ref_l0 : c->n_ref_l1;
        nb_poc = ref < npocs ? pocs[ref] : pocs[0];
        if (nb_poc == target_poc) { out_mv[0] = mvx; out_mv[1] = mvy;
                                    return 1; }
        if (scaled) {
            d_scale_mv(mvx, mvy, c->cur_poc - target_poc,
                       c->cur_poc - nb_poc, out_mv);
            return 1;
        }
    }
    return 0;
}

/* §8.5.3.2.6-7 AMVP pair for list lx (TMVP off) */
static void d_amvp_candidates(const Der *c, int x0, int y0, int w, int h,
                              int lx, int ref_idx, int cands[2][2]) {
    MC a0, a1, bs[3];
    int has_a0, has_a1, has_b[3];
    int is_scaled, i;
    int mv_a[2], mv_b[2], got_a = 0, got_b = 0;

    has_a0 = nbr_motion(c, x0, y0, x0 - 1, y0 + h, &a0);
    has_a1 = nbr_motion(c, x0, y0, x0 - 1, y0 + h - 1, &a1);
    is_scaled = has_a0 || has_a1;

    if (has_a0) got_a = d_amvp_from(c, &a0, lx, ref_idx, 0, mv_a);
    if (!got_a && has_a1) got_a = d_amvp_from(c, &a1, lx, ref_idx, 0, mv_a);
    if (!got_a) {
        if (has_a0) got_a = d_amvp_from(c, &a0, lx, ref_idx, 1, mv_a);
        if (!got_a && has_a1)
            got_a = d_amvp_from(c, &a1, lx, ref_idx, 1, mv_a);
    }

    has_b[0] = nbr_motion(c, x0, y0, x0 + w, y0 - 1, &bs[0]);
    has_b[1] = nbr_motion(c, x0, y0, x0 + w - 1, y0 - 1, &bs[1]);
    has_b[2] = nbr_motion(c, x0, y0, x0 - 1, y0 - 1, &bs[2]);
    for (i = 0; i < 3 && !got_b; i++)
        if (has_b[i]) got_b = d_amvp_from(c, &bs[i], lx, ref_idx, 0, mv_b);
    if (!is_scaled) {
        /* §8.5.3.2.7: no A neighbors -> unscaled B fills the A slot and
         * the B slot re-derives with scaling */
        if (!got_a && got_b) {
            mv_a[0] = mv_b[0]; mv_a[1] = mv_b[1];
            got_a = 1; got_b = 0;
        }
        for (i = 0; i < 3 && !got_b; i++)
            if (has_b[i])
                got_b = d_amvp_from(c, &bs[i], lx, ref_idx, 1, mv_b);
    }

    {
    int n = 0;
    if (got_a) { cands[n][0] = mv_a[0]; cands[n][1] = mv_a[1]; n++; }
    if (got_b && !(got_a && mv_b[0] == mv_a[0] && mv_b[1] == mv_a[1])
        && n < 2) {
        cands[n][0] = mv_b[0]; cands[n][1] = mv_b[1]; n++;
    }
    if (n < 2 && c->tmvp) {
        /* §8.5.3.2.6: temporal, not pruned against the spatials */
        int t[2];
        if (d_temporal_mv(c, x0, y0, w, h, lx, ref_idx, t)) {
            cands[n][0] = t[0]; cands[n][1] = t[1]; n++;
        }
    }
    while (n < 2) { cands[n][0] = 0; cands[n][1] = 0; n++; }
    }
}

static int d_region_nz(const int32_t *plane, int stride, int x, int y,
                       int sz) {
    int yy, xx;
    for (yy = 0; yy < sz; yy++)
        for (xx = 0; xx < sz; xx++)
            if (plane[(y + yy) * stride + x + xx]) return 1;
    return 0;
}

static void d_set_region_u8(uint8_t *arr, int w4, int x0, int y0, int size,
                            uint8_t v) {
    int s4 = size >> 2, yy, xx;
    for (yy = 0; yy < s4; yy++)
        for (xx = 0; xx < s4; xx++)
            arr[((y0 >> 2) + yy) * w4 + (x0 >> 2) + xx] = v;
}

static void d_set_region_mv(int16_t *arr, int w4, int x0, int y0, int size,
                            int vx, int vy) {
    int s4 = size >> 2, yy, xx;
    for (yy = 0; yy < s4; yy++)
        for (xx = 0; xx < s4; xx++) {
            arr[(((y0 >> 2) + yy) * w4 + (x0 >> 2) + xx) * 2] = (int16_t)vx;
            arr[(((y0 >> 2) + yy) * w4 + (x0 >> 2) + xx) * 2 + 1] =
                (int16_t)vy;
        }
}

static void d_derive_cu(Der *c, int x0, int y0, int size) {
    int y4 = y0 >> 2, x4 = x0 >> 2;
    MC me, cands[8];
    int ncand, i, d, found = -1;

    if (c->pred_mode[y4 * c->w4 + x4] == 1) return;      /* intra */
    d = c->inter_dir ? c->inter_dir[y4 * c->w4 + x4] : 0;
    if (d == 0) d = 1;
    me.dir = d;
    me.mv0x = c->mv0[(y4 * c->w4 + x4) * 2];
    me.mv0y = c->mv0[(y4 * c->w4 + x4) * 2 + 1];
    me.ref0 = c->ref_idx0 ? c->ref_idx0[y4 * c->w4 + x4] : 0;
    me.mv1x = c->mv1 ? c->mv1[(y4 * c->w4 + x4) * 2] : 0;
    me.mv1y = c->mv1 ? c->mv1[(y4 * c->w4 + x4) * 2 + 1] : 0;
    me.ref1 = c->ref_idx1 ? c->ref_idx1[y4 * c->w4 + x4] : 0;

    ncand = d_merge_candidates(c, x0, y0, size, size, cands);
    for (i = 0; i < ncand; i++)
        if (mc_eq(&me, &cands[i])) { found = i; break; }
    if (found >= 0) {
        d_set_region_u8(c->merge_flag, c->w4, x0, y0, size, 1);
        d_set_region_u8(c->merge_idx, c->w4, x0, y0, size,
                        (uint8_t)found);
        /* skip: merged CU with no residual anywhere */
        if (!d_region_nz(c->cy, c->ystride, x0, y0, size)
            && !d_region_nz(c->ccb, c->cstride, x0 >> 1, y0 >> 1,
                            size >> 1)
            && !d_region_nz(c->ccr, c->cstride, x0 >> 1, y0 >> 1,
                            size >> 1))
            d_set_region_u8(c->skip, c->w4, x0, y0, size, 1);
        return;
    }
    if (d & 1) {
        int amvp[2][2], c0, c1, mvp;
        d_amvp_candidates(c, x0, y0, size, size, 0, me.ref0, amvp);
        c0 = abs(me.mv0x - amvp[0][0]) + abs(me.mv0y - amvp[0][1]);
        c1 = abs(me.mv0x - amvp[1][0]) + abs(me.mv0y - amvp[1][1]);
        mvp = c1 < c0 ? 1 : 0;
        d_set_region_u8(c->mvp_flag, c->w4, x0, y0, size, (uint8_t)mvp);
        d_set_region_mv(c->mvd, c->w4, x0, y0, size,
                        me.mv0x - amvp[mvp][0], me.mv0y - amvp[mvp][1]);
    }
    if (d & 2) {
        int amvp[2][2], c0, c1, mvp;
        d_amvp_candidates(c, x0, y0, size, size, 1, me.ref1, amvp);
        c0 = abs(me.mv1x - amvp[0][0]) + abs(me.mv1y - amvp[0][1]);
        c1 = abs(me.mv1x - amvp[1][0]) + abs(me.mv1y - amvp[1][1]);
        mvp = c1 < c0 ? 1 : 0;
        d_set_region_u8(c->mvp_flag1, c->w4, x0, y0, size, (uint8_t)mvp);
        d_set_region_mv(c->mvd1, c->w4, x0, y0, size,
                        me.mv1x - amvp[mvp][0], me.mv1y - amvp[mvp][1]);
    }
}

static void d_walk(Der *c, int x0, int y0, int log2_size, int dep) {
    int size = 1 << log2_size;
    int fits = (x0 + size <= c->w) && (y0 + size <= c->h);
    int split = !fits
        || c->depth[(y0 >> 2) * c->w4 + (x0 >> 2)] > dep;
    if (split && log2_size > c->min_cb) {
        int half = size >> 1, i;
        for (i = 0; i < 4; i++) {
            int x1 = x0 + (i & 1) * half, y1 = y0 + (i >> 1) * half;
            if (x1 < c->w && y1 < c->h)
                d_walk(c, x1, y1, log2_size - 1, dep + 1);
        }
        return;
    }
    d_derive_cu(c, x0, y0, size);
}

long derive_inter_syntax(
    const uint8_t *depth, const uint8_t *pred_mode,
    const uint8_t *inter_dir, const uint8_t *ref_idx0,
    const uint8_t *ref_idx1,
    const int16_t *mv0, const int16_t *mv1,
    const int32_t *coeff_y, const int32_t *coeff_cb,
    const int32_t *coeff_cr, const int64_t *zscan,
    int width, int height, int w4, int h4,
    int log2_ctb, int log2_min_cb, int max_merge, int cur_poc,
    const int32_t *ref_pocs_l0, int n_ref_l0,
    const int32_t *ref_pocs_l1, int n_ref_l1,
    uint8_t *merge_flag, uint8_t *merge_idx,
    uint8_t *mvp_flag, uint8_t *mvp_flag1,
    int16_t *mvd, int16_t *mvd1, uint8_t *skip)
{
    Der c;
    int ctb_size, ctbs_w, ctbs_h, ctu, n_ctbs;
    memset(&c, 0, sizeof(c));
    c.depth = depth; c.pred_mode = pred_mode; c.inter_dir = inter_dir;
    c.ref_idx0 = ref_idx0; c.ref_idx1 = ref_idx1;
    c.mv0 = mv0; c.mv1 = mv1;
    c.cy = coeff_y; c.ccb = coeff_cb; c.ccr = coeff_cr; c.zscan = zscan;
    c.w = width; c.h = height; c.w4 = w4; c.h4 = h4;
    c.ystride = w4 * 4; c.cstride = w4 * 2;
    c.min_cb = log2_min_cb; c.max_merge = max_merge;
    c.log2_ctb = log2_ctb;
    c.cur_poc = cur_poc;
    c.ref_pocs_l0 = ref_pocs_l0; c.n_ref_l0 = n_ref_l0;
    c.ref_pocs_l1 = ref_pocs_l1; c.n_ref_l1 = n_ref_l1;
    c.merge_flag = merge_flag; c.merge_idx = merge_idx;
    c.mvp_flag = mvp_flag; c.mvp_flag1 = mvp_flag1;
    c.mvd = mvd; c.mvd1 = mvd1; c.skip = skip;

    ctb_size = 1 << log2_ctb;
    ctbs_w = (width + ctb_size - 1) >> log2_ctb;
    ctbs_h = (height + ctb_size - 1) >> log2_ctb;
    n_ctbs = ctbs_w * ctbs_h;
    for (ctu = 0; ctu < n_ctbs; ctu++)
        d_walk(&c, (ctu % ctbs_w) << log2_ctb,
               (ctu / ctbs_w) << log2_ctb, log2_ctb, 0);
    return 0;
}

/* derive_inter_syntax with the TMVP collocated field attached (twin of
 * motion.py temporal_mv; same arguments + the col arrays). */
long derive_inter_syntax_tmvp(
    const uint8_t *depth, const uint8_t *pred_mode,
    const uint8_t *inter_dir, const uint8_t *ref_idx0,
    const uint8_t *ref_idx1,
    const int16_t *mv0, const int16_t *mv1,
    const int32_t *coeff_y, const int32_t *coeff_cb,
    const int32_t *coeff_cr, const int64_t *zscan,
    int width, int height, int w4, int h4,
    int log2_ctb, int log2_min_cb, int max_merge, int cur_poc,
    const int32_t *ref_pocs_l0, int n_ref_l0,
    const int32_t *ref_pocs_l1, int n_ref_l1,
    uint8_t *merge_flag, uint8_t *merge_idx,
    uint8_t *mvp_flag, uint8_t *mvp_flag1,
    int16_t *mvd, int16_t *mvd1, uint8_t *skip,
    const uint8_t *col_pred, const uint8_t *col_dir,
    const int16_t *col_mv0, const int16_t *col_mv1,
    const int32_t *col_poc0, const int32_t *col_poc1, int col_poc)
{
    Der c;
    int ctb_size, ctbs_w, ctbs_h, ctu, n_ctbs;
    memset(&c, 0, sizeof(c));
    c.depth = depth; c.pred_mode = pred_mode; c.inter_dir = inter_dir;
    c.ref_idx0 = ref_idx0; c.ref_idx1 = ref_idx1;
    c.mv0 = mv0; c.mv1 = mv1;
    c.cy = coeff_y; c.ccb = coeff_cb; c.ccr = coeff_cr; c.zscan = zscan;
    c.w = width; c.h = height; c.w4 = w4; c.h4 = h4;
    c.ystride = w4 * 4; c.cstride = w4 * 2;
    c.min_cb = log2_min_cb; c.max_merge = max_merge;
    c.log2_ctb = log2_ctb;
    c.cur_poc = cur_poc;
    c.ref_pocs_l0 = ref_pocs_l0; c.n_ref_l0 = n_ref_l0;
    c.ref_pocs_l1 = ref_pocs_l1; c.n_ref_l1 = n_ref_l1;
    c.merge_flag = merge_flag; c.merge_idx = merge_idx;
    c.mvp_flag = mvp_flag; c.mvp_flag1 = mvp_flag1;
    c.mvd = mvd; c.mvd1 = mvd1; c.skip = skip;
    c.tmvp = 1;
    c.col_pred = col_pred; c.col_dir = col_dir;
    c.col_mv0 = col_mv0; c.col_mv1 = col_mv1;
    c.col_poc0 = col_poc0; c.col_poc1 = col_poc1;
    c.col_poc = col_poc;

    ctb_size = 1 << log2_ctb;
    ctbs_w = (width + ctb_size - 1) >> log2_ctb;
    ctbs_h = (height + ctb_size - 1) >> log2_ctb;
    n_ctbs = ctbs_w * ctbs_h;
    for (ctu = 0; ctu < n_ctbs; ctu++)
        d_walk(&c, (ctu % ctbs_w) << log2_ctb,
               (ctu / ctbs_w) << log2_ctb, log2_ctb, 0);
    return 0;
}

/* ---- input dithering (x265-extras.cpp:284 ditherPlane; x264-derived
 * error-diffusion when input bit depth exceeds the internal depth).
 * src: uint16 samples already left-shifted to 16-bit range; dst: the
 * target-depth samples. ---- */
void dither_plane(uint16_t *dst, const uint16_t *src, int width,
                  int height, int16_t *errors, int bit_depth) {
    const int l_shift = 16 - bit_depth;
    const int r_shift = 16 - bit_depth + 2;
    const int half = 1 << (16 - bit_depth + 1);
    const int pixel_max = (1 << bit_depth) - 1;
    int x, y;
    for (x = 0; x <= width; x++) errors[x] = 0;
    for (y = 0; y < height; y++) {
        int16_t err = 0;
        const uint16_t *s = src + (size_t)y * width;
        uint16_t *o = dst + (size_t)y * width;
        for (x = 0; x < width; x++) {
            int v;
            err = (int16_t)(err * 2 + errors[x] + errors[x + 1]);
            v = ((s[x] << 2) + err + half) >> r_shift;
            if (v < 0) v = 0;
            if (v > pixel_max) v = pixel_max;
            o[x] = (uint16_t)v;
            errors[x] = err = (int16_t)(s[x] - (o[x] << l_shift));
        }
    }
}
