/* Run-length-encoded binary mask operations (a copy of
 * mx_rcnn_tpu/native/rlelib.c).
 *
 * Masks are stored column-major as alternating run lengths starting with
 * a zero-run (the uncompressed COCO RLE convention).  This library backs
 * the host-side segm evaluation path and the synthetic polygon records.
 *
 * Built at first use by native/rle.py with the host C compiler and bound
 * via ctypes.
 */

#include <stdlib.h>
#include <string.h>

typedef unsigned int uint;
typedef unsigned char byte;

/* encode one h*w column-major binary mask into run lengths.
 * cnts must hold h*w+1 entries; returns the run count. */
int rle_encode(const byte *m, int h, int w, uint *cnts) {
    long n = (long)h * w;
    int k = 0;
    byte prev = 0;
    uint run = 0;
    for (long i = 0; i < n; i++) {
        byte v = m[i] ? 1 : 0;
        if (v != prev) {
            cnts[k++] = run;
            run = 0;
            prev = v;
        }
        run++;
    }
    cnts[k++] = run;
    return k;
}

/* decode run lengths into an h*w column-major binary mask. */
void rle_decode(const uint *cnts, int k, byte *m) {
    byte v = 0;
    long pos = 0;
    for (int i = 0; i < k; i++) {
        memset(m + pos, v, cnts[i]);
        pos += cnts[i];
        v = !v;
    }
}

/* total foreground area of an RLE. */
double rle_area(const uint *cnts, int k) {
    double a = 0;
    for (int i = 1; i < k; i += 2) a += cnts[i];
    return a;
}

/* run-length sweep intersection area of two RLEs. */
static double rle_inter(const uint *a, int ka, const uint *b, int kb) {
    double inter = 0;
    long ca = a[0], cb = b[0];
    int ia = 0, ib = 0;       /* index of the CURRENT run in each mask */
    byte va = 0, vb = 0;      /* value of the current run */
    while (ia < ka && ib < kb) {
        long step = ca < cb ? ca : cb;
        if (va && vb) inter += step;
        ca -= step;
        cb -= step;
        if (ca == 0 && ++ia < ka) { ca = a[ia]; va = !va; }
        if (cb == 0 && ++ib < kb) { cb = b[ib]; vb = !vb; }
    }
    return inter;
}

/* IoU matrix between n dt and m gt RLEs (all padded into one buffer of
 * stride max_k with per-mask run counts).  iscrowd gt: inter/dt_area. */
void rle_iou(const uint *dt, const int *dt_k, int n,
             const uint *gt, const int *gt_k, int m,
             const byte *iscrowd, int max_k, double *out) {
    for (int i = 0; i < n; i++) {
        const uint *a = dt + (long)i * max_k;
        double area_a = rle_area(a, dt_k[i]);
        for (int j = 0; j < m; j++) {
            const uint *b = gt + (long)j * max_k;
            double inter = rle_inter(a, dt_k[i], b, gt_k[j]);
            double u;
            if (iscrowd[j]) {
                u = area_a;
            } else {
                u = area_a + rle_area(b, gt_k[j]) - inter;
            }
            out[(long)i * m + j] = u > 0 ? inter / u : 0.0;
        }
    }
}

/* union-merge of n RLEs (same h*w) into out counts; returns run count. */
int rle_merge(const uint *rles, const int *ks, int n, int max_k,
              long hw, uint *out) {
    /* simple approach: decode-or into a scratch mask, re-encode */
    byte *scratch = (byte *)calloc(hw, 1);
    byte *tmp = (byte *)malloc(hw);
    if (!scratch || !tmp) { free(scratch); free(tmp); return -1; }
    for (int i = 0; i < n; i++) {
        rle_decode(rles + (long)i * max_k, ks[i], tmp);
        for (long p = 0; p < hw; p++) scratch[p] |= tmp[p];
    }
    int k = rle_encode(scratch, 1, (int)hw, out);
    free(scratch);
    free(tmp);
    return k;
}

/* rasterize a closed polygon (xy pairs, image h*w) into a column-major
 * mask via even-odd scanline fill on pixel centers; OR-ed into m. */
void poly_fill(const double *xy, int npts, int h, int w, byte *m) {
    if (npts < 3) return;
    for (int col = 0; col < w; col++) {
        double px = col + 0.5;
        /* gather crossings of the vertical line x=px */
        double ys[4096];
        int nys = 0;
        for (int i = 0; i < npts && nys < 4096; i++) {
            int j = (i + 1) % npts;
            double x0 = xy[2 * i], y0 = xy[2 * i + 1];
            double x1 = xy[2 * j], y1 = xy[2 * j + 1];
            if ((x0 <= px && x1 > px) || (x1 <= px && x0 > px)) {
                double t = (px - x0) / (x1 - x0);
                ys[nys++] = y0 + t * (y1 - y0);
            }
        }
        /* sort crossings (insertion: counts are tiny) */
        for (int i = 1; i < nys; i++) {
            double v = ys[i];
            int j = i - 1;
            while (j >= 0 && ys[j] > v) { ys[j + 1] = ys[j]; j--; }
            ys[j + 1] = v;
        }
        /* fill rows whose pixel center lies between alternate pairs */
        for (int i = 0; i + 1 < nys; i += 2) {
            int r0 = (int)(ys[i]);          /* first r with r+0.5 >= ys[i] */
            if (r0 + 0.5 < ys[i]) r0++;
            int r1 = (int)(ys[i + 1]);      /* last r with r+0.5 <= ys[i+1] */
            if (r1 + 0.5 > ys[i + 1]) r1--;
            if (r0 < 0) r0 = 0;
            if (r1 >= h) r1 = h - 1;
            for (int r = r0; r <= r1; r++)
                m[(long)col * h + r] = 1;
        }
    }
}
