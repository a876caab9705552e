/* Baseline and progressive Huffman JPEG decoder, pixel-identical to
 * libjpeg-turbo's default decompression to RGB (what OpenCV's
 * cv2.imread(path, IMREAD_COLOR) returns, in RGB order).
 *
 * It follows libjpeg's algorithms step by step:
 *   - entropy decoding: jdhuff.c (sequential) and jdphuff.c (progressive:
 *     DC first / refine, AC first / refine with EOB runs); restart markers
 *     in both modes.  Every scan decodes into a coefficient buffer for the
 *     whole image, and the IDCT runs after the last scan;
 *   - dequantization and IDCT: jidctint.c's jpeg_idct_islow (CONST_BITS 13,
 *     PASS1_BITS 2, the column pass's all-AC-zero shortcut, the post-IDCT
 *     range_limit table indexed with RANGE_MASK);
 *   - chroma upsampling: jdsample.c's triangle ("fancy") filters for h2v1,
 *     h1v2 and h2v2 (h2v1 / h2v2 only where the component is wider than 2
 *     samples), with jdmainct.c's edge replication at the top and bottom,
 *     and plain replication (int_upsample) for every other integral ratio;
 *   - colour conversion: jdcolor.c's fixed-point ycc_rgb_convert tables;
 *     a one-component file comes back as three equal channels;
 *   - the EXIF orientation tag (APP1, values 1-8) is applied to the output,
 *     as OpenCV's imread does by default.
 *
 * What libjpeg would decode only with its error concealment (a truncated or
 * corrupt entropy stream, a missing EOI) raises here instead, as do the
 * features left out: arithmetic coding, 12-bit and lossless (SOF3) or
 * hierarchical files, 2- and 4-component (CMYK / YCCK) files, Huffman
 * tables a scan uses but the file does not define, and progressive files
 * whose scans leave coefficients unrefined (libjpeg's block smoothing).
 *
 * Interface (ctypes, native/jpeg.py): jpeg_info gives the output's width,
 * height, source components and EXIF orientation; jpeg_decode writes the
 * RGB uint8 image, height x width x 3, into a caller-provided buffer.  Both
 * return 0, or -1 with a message naming the case in err.
 */

#include <setjmp.h>
#include <stdarg.h>
#include <stddef.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define MAX_COMPS 4

static const int natural_order[64] = {
     0,  1,  8, 16,  9,  2,  3, 10, 17, 24, 32, 25, 18, 11,  4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,  6,  7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
};

typedef struct {
    int present;
    uint8_t vals[256];
    int32_t maxcode[17];  /* largest code of each length, -1 if none */
    int32_t valptr[17];
    int32_t mincode[17];
    uint16_t lut[1 << 9]; /* 9-bit lookahead: (length << 8) | value, 0 = longer */
} Huff;

typedef struct {
    int id, h, v, tq;
    int cw, ch;           /* downsampled width / height in samples */
    int bw, bh;           /* blocks holding real samples */
    int bw_alloc, bh_alloc;
    int td, ta;           /* the current scan's table selectors */
    int dc_pred;
    int scanned;
    int latched;
    int32_t q[64];        /* quantization table latched at the first scan */
    int coef_bits[64];    /* progressive: last Al of each coefficient, -1 if never coded */
    int16_t *coef;        /* bh_alloc x bw_alloc blocks of 64 */
    uint8_t *plane;       /* bh * 8 rows x bw * 8 samples, after the IDCT */
} Comp;

typedef struct {
    const uint8_t *data;
    size_t n, pos;
    jmp_buf fail;
    char *err;
    int errlen;

    /* frame */
    int sof, progressive, width, height, ncomp;
    int hmax, vmax, mcux, mcuy;
    Comp comp[MAX_COMPS];
    int32_t qt[4][64];
    int qt_present[4];
    Huff dc[4], ac[4];
    int restart_interval;
    int saw_jfif, saw_adobe, adobe_transform;
    int orientation;

    /* scan */
    int scomp[MAX_COMPS], ns, ss, se, ah, al;
    int eobrun;

    /* jdmaster.c's sample_range_limit and jdcolor.c's YCbCr tables */
    uint8_t range[5 * 256 + 128];
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];

    /* bit reader */
    uint64_t bitbuf;
    int bitcnt;           /* valid bits in bitbuf (low end) */
    int fake_bits;        /* zero bits appended past the segment's end */
    int marker_hit;
    size_t marker_pos;
} Dec;

static void fail(Dec *d, const char *fmt, ...) {
    va_list ap;
    va_start(ap, fmt);
    vsnprintf(d->err, (size_t)d->errlen, fmt, ap);
    va_end(ap);
    longjmp(d->fail, 1);
}

static void truncated(Dec *d, size_t at) {
    fail(d, "truncated or corrupt JPEG: the data ends early at byte %zu", at);
}

/* ------------------------------------------------------------ markers */

static unsigned get_u8(Dec *d) {
    if (d->pos >= d->n) truncated(d, d->pos);
    return d->data[d->pos++];
}

static unsigned get_u16(Dec *d) {
    unsigned hi = get_u8(d);
    return (hi << 8) | get_u8(d);
}

/* Next marker code: skips fill bytes (and, as libjpeg does, any garbage
 * before the marker). */
static unsigned next_marker(Dec *d) {
    for (;;) {
        while (get_u8(d) != 0xFF) {}
        unsigned c;
        do c = get_u8(d); while (c == 0xFF);
        if (c != 0) return c;
    }
}

static void read_dqt(Dec *d, size_t end) {
    while (d->pos < end) {
        unsigned pq_tq = get_u8(d);
        unsigned pq = pq_tq >> 4, tq = pq_tq & 15;
        if (tq > 3 || pq > 1) fail(d, "corrupt JPEG: bad DQT table %u/%u at byte %zu", pq, tq, d->pos);
        for (int i = 0; i < 64; i++) {
            unsigned v = pq ? get_u16(d) : get_u8(d);
            /* libjpeg keeps the islow multipliers as 16-bit */
            d->qt[tq][natural_order[i]] = (int16_t)v;
        }
        d->qt_present[tq] = 1;
    }
}

static void build_huff(Dec *d, Huff *h, const uint8_t bits[17], int nvals) {
    int code = 0, k = 0;
    for (int len = 1; len <= 16; len++) {
        h->valptr[len] = k;
        h->mincode[len] = code;
        code += bits[len];
        k += bits[len];
        h->maxcode[len] = bits[len] ? code - 1 : -1;
        /* as libjpeg: no code may be all ones */
        if (bits[len] && code >= (1 << len)) fail(d, "corrupt JPEG: bad Huffman table at byte %zu", d->pos);
        code <<= 1;
    }
    if (k != nvals) fail(d, "corrupt JPEG: bad Huffman table at byte %zu", d->pos);
    memset(h->lut, 0, sizeof(h->lut));
    code = 0;
    k = 0;
    for (int len = 1; len <= 9; len++) {
        for (int i = 0; i < bits[len]; i++, code++, k++) {
            int base = code << (9 - len);
            for (int j = 0; j < (1 << (9 - len)); j++)
                h->lut[base + j] = (uint16_t)((len << 8) | h->vals[k]);
        }
        code <<= 1;
    }
    h->present = 1;
}

static void read_dht(Dec *d, size_t end) {
    while (d->pos < end) {
        unsigned tc_th = get_u8(d);
        unsigned tc = tc_th >> 4, th = tc_th & 15;
        if (tc > 1 || th > 3) fail(d, "corrupt JPEG: bad DHT table %u/%u at byte %zu", tc, th, d->pos);
        uint8_t bits[17] = {0};
        int count = 0;
        for (int i = 1; i <= 16; i++) {
            bits[i] = (uint8_t)get_u8(d);
            count += bits[i];
        }
        if (count > 256) fail(d, "corrupt JPEG: bad Huffman table at byte %zu", d->pos);
        Huff *h = tc ? &d->ac[th] : &d->dc[th];
        for (int i = 0; i < count; i++) h->vals[i] = (uint8_t)get_u8(d);
        build_huff(d, h, bits, count);
    }
}

static unsigned exif_u16(const uint8_t *p, int le) {
    return le ? (unsigned)(p[0] | (p[1] << 8)) : (unsigned)((p[0] << 8) | p[1]);
}

static uint32_t exif_u32(const uint8_t *p, int le) {
    return le ? (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24)
              : ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) | ((uint32_t)p[2] << 8) | (uint32_t)p[3];
}

/* The orientation tag (0x0112) of IFD0 in an "Exif\0\0" APP1 segment; a
 * malformed block leaves the orientation unset. */
static void read_exif(Dec *d, const uint8_t *p, size_t len) {
    if (d->orientation || len < 14 || memcmp(p, "Exif\0\0", 6) != 0) return;
    const uint8_t *t = p + 6;
    size_t tn = len - 6;
    int le;
    if (t[0] == 'I' && t[1] == 'I') le = 1;
    else if (t[0] == 'M' && t[1] == 'M') le = 0;
    else return;
    if (exif_u16(t + 2, le) != 42) return;
    uint32_t ifd = exif_u32(t + 4, le);
    if (ifd > tn || tn - ifd < 2) return;
    unsigned entries = exif_u16(t + ifd, le);
    for (unsigned i = 0; i < entries; i++) {
        size_t e = ifd + 2 + (size_t)i * 12;
        if (e + 12 > tn) return;
        if (exif_u16(t + e, le) == 0x0112) {
            unsigned type = exif_u16(t + e + 2, le);
            unsigned v = type == 3 ? exif_u16(t + e + 8, le) : 0;
            d->orientation = (v >= 1 && v <= 8) ? (int)v : 1;
            return;
        }
    }
}

static void read_app(Dec *d, unsigned marker, size_t end) {
    const uint8_t *p = d->data + d->pos;
    size_t len = end - d->pos;
    if (marker == 0xE0 && len >= 5 && memcmp(p, "JFIF\0", 5) == 0) d->saw_jfif = 1;
    if (marker == 0xE1) read_exif(d, p, len);
    if (marker == 0xEE && len >= 12 && memcmp(p, "Adobe", 5) == 0) {
        d->saw_adobe = 1;
        d->adobe_transform = p[11];
    }
}

static void read_sof(Dec *d, unsigned marker) {
    if (d->sof) fail(d, "corrupt JPEG: a second SOF marker at byte %zu", d->pos);
    if (marker == 0xC3)
        fail(d, "lossless JPEG (SOF3) is not supported");
    if (marker == 0xC5 || marker == 0xC6 || marker == 0xC7)
        fail(d, "hierarchical JPEG (SOF%u) is not supported", marker - 0xC0);
    if (marker >= 0xC9)
        fail(d, "arithmetic-coded JPEG (SOF%u) is not supported", marker - 0xC0);
    unsigned len = get_u16(d);
    size_t end = d->pos + len - 2;
    unsigned precision = get_u8(d);
    if (precision != 8) fail(d, "%u-bit JPEG is not supported (8-bit samples only)", precision);
    d->height = (int)get_u16(d);
    d->width = (int)get_u16(d);
    d->ncomp = (int)get_u8(d);
    if (d->height == 0) fail(d, "JPEG whose height comes in a DNL marker is not supported");
    if (d->width == 0) fail(d, "corrupt JPEG: image width 0");
    /* OpenCV's imread refuses the same (CV_IO_MAX_IMAGE_PIXELS) */
    if ((uint64_t)d->width * (uint64_t)d->height > ((uint64_t)1 << 30))
        fail(d, "JPEG of %d x %d pixels exceeds the 2^30-pixel limit", d->width, d->height);
    if (d->ncomp == 4) fail(d, "4-component (CMYK / YCCK) JPEG is not supported");
    if (d->ncomp != 1 && d->ncomp != 3)
        fail(d, "%d-component JPEG is not supported (1 or 3 components)", d->ncomp);
    if (len != 8 + 3 * (unsigned)d->ncomp) fail(d, "corrupt JPEG: bad SOF length");
    d->hmax = d->vmax = 1;
    for (int i = 0; i < d->ncomp; i++) {
        Comp *c = &d->comp[i];
        c->id = (int)get_u8(d);
        unsigned hv = get_u8(d);
        c->h = (int)(hv >> 4);
        c->v = (int)(hv & 15);
        c->tq = (int)get_u8(d);
        if (c->h < 1 || c->h > 4 || c->v < 1 || c->v > 4 || c->tq > 3)
            fail(d, "corrupt JPEG: bad sampling factors or table in SOF");
        if (c->h > d->hmax) d->hmax = c->h;
        if (c->v > d->vmax) d->vmax = c->v;
    }
    d->pos = end;
    d->sof = (int)marker;
    d->progressive = marker == 0xC2;
}

static void allocate(Dec *d) {
    d->mcux = (d->width + 8 * d->hmax - 1) / (8 * d->hmax);
    d->mcuy = (d->height + 8 * d->vmax - 1) / (8 * d->vmax);
    for (int i = 0; i < d->ncomp; i++) {
        Comp *c = &d->comp[i];
        if (d->hmax % c->h || d->vmax % c->v)
            fail(d, "JPEG with fractional sampling ratios is not supported");
        c->cw = (int)(((long)d->width * c->h + d->hmax - 1) / d->hmax);
        c->ch = (int)(((long)d->height * c->v + d->vmax - 1) / d->vmax);
        c->bw = (c->cw + 7) / 8;
        c->bh = (c->ch + 7) / 8;
        c->bw_alloc = d->mcux * c->h;
        c->bh_alloc = d->mcuy * c->v;
        c->coef = (int16_t *)calloc((size_t)c->bw_alloc * c->bh_alloc * 64, sizeof(int16_t));
        if (!c->coef) fail(d, "out of memory for a %dx%d JPEG", d->width, d->height);
        for (int k = 0; k < 64; k++) c->coef_bits[k] = -1;
    }
}

/* --------------------------------------------------------- bit reader */

static void reset_bits(Dec *d) {
    d->bitbuf = 0;
    d->bitcnt = 0;
    d->fake_bits = 0;
    d->marker_hit = 0;
}

static void fill(Dec *d) {
    while (d->bitcnt <= 56) {
        unsigned b = 0;
        if (d->marker_hit) {
            d->fake_bits += 8;
        } else if (d->pos >= d->n) {
            d->marker_hit = 1;
            d->marker_pos = d->pos;
            d->fake_bits += 8;
        } else if (d->data[d->pos] != 0xFF) {
            b = d->data[d->pos++];
        } else {
            size_t p = d->pos + 1;
            while (p < d->n && d->data[p] == 0xFF) p++;
            if (p < d->n && d->data[p] == 0) {
                b = 0xFF;
                d->pos = p + 1;
            } else {
                d->marker_hit = 1;
                d->marker_pos = d->pos;
                d->fake_bits += 8;
            }
        }
        d->bitbuf = (d->bitbuf << 8) | b;
        d->bitcnt += 8;
    }
}

static inline unsigned peek(Dec *d, int nbits) {
    if (d->bitcnt < nbits) fill(d);
    return (unsigned)(d->bitbuf >> (d->bitcnt - nbits)) & ((1u << nbits) - 1);
}

static inline void consume(Dec *d, int nbits) {
    d->bitcnt -= nbits;
    if (d->bitcnt < d->fake_bits) truncated(d, d->marker_pos);
}

static inline unsigned get_bits(Dec *d, int nbits) {
    if (nbits == 0) return 0;
    unsigned v = peek(d, nbits);
    consume(d, nbits);
    return v;
}

static inline int extend(unsigned v, int s) {
    return s == 0 ? 0 : (v < (1u << (s - 1)) ? (int)v - (1 << s) + 1 : (int)v);
}

static int decode_huff(Dec *d, const Huff *h) {
    unsigned look = peek(d, 16);
    unsigned e = h->lut[look >> 7];
    if (e) {
        consume(d, (int)(e >> 8));
        return (int)(e & 255);
    }
    for (int len = 10; len <= 16; len++) {
        int code = (int)(look >> (16 - len));
        if (code <= h->maxcode[len]) {
            consume(d, len);
            return h->vals[h->valptr[len] + code - h->mincode[len]];
        }
    }
    fail(d, "corrupt JPEG data: bad Huffman code near byte %zu", d->pos);
    return 0;
}

/* ---------------------------------------------------- block decoders */

static void decode_block_seq(Dec *d, Comp *c, int16_t *blk) {
    int s = decode_huff(d, &d->dc[c->td]);
    if (s > 16) fail(d, "corrupt JPEG data: bad DC magnitude near byte %zu", d->pos);
    c->dc_pred += extend(get_bits(d, s), s);
    blk[0] = (int16_t)c->dc_pred;
    const Huff *ac = &d->ac[c->ta];
    for (int k = 1; k < 64; k++) {
        int rs = decode_huff(d, ac);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
            k += r;
            if (k > 63) fail(d, "corrupt JPEG data: AC run past the block near byte %zu", d->pos);
            blk[natural_order[k]] = (int16_t)extend(get_bits(d, s), s);
        } else if (r == 15) {
            k += 15;
        } else {
            break;
        }
    }
}

static void decode_dc_first(Dec *d, Comp *c, int16_t *blk) {
    int s = decode_huff(d, &d->dc[c->td]);
    if (s > 16) fail(d, "corrupt JPEG data: bad DC magnitude near byte %zu", d->pos);
    c->dc_pred += extend(get_bits(d, s), s);
    blk[0] = (int16_t)(int)((unsigned)c->dc_pred << d->al);
}

static void decode_dc_refine(Dec *d, Comp *c, int16_t *blk) {
    (void)c;
    if (get_bits(d, 1)) blk[0] = (int16_t)(blk[0] | (1 << d->al));
}

static void decode_ac_first(Dec *d, Comp *c, int16_t *blk) {
    if (d->eobrun > 0) {
        d->eobrun--;
        return;
    }
    const Huff *ac = &d->ac[c->ta];
    for (int k = d->ss; k <= d->se; k++) {
        int rs = decode_huff(d, ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
            k += r;
            if (k > 63) fail(d, "corrupt JPEG data: AC run past the block near byte %zu", d->pos);
            int v = extend(get_bits(d, s), s);
            blk[natural_order[k]] = (int16_t)(int)((unsigned)v << d->al);
        } else if (r == 15) {
            k += 15;
        } else {
            d->eobrun = 1 << r;
            if (r) d->eobrun += (int)get_bits(d, r);
            d->eobrun--;
            break;
        }
    }
}

static void refine_nonzero(Dec *d, int16_t *coef, int p1, int m1) {
    if (get_bits(d, 1) && (*coef & p1) == 0) *coef = (int16_t)(*coef + (*coef >= 0 ? p1 : m1));
}

static void decode_ac_refine(Dec *d, Comp *c, int16_t *blk) {
    int p1 = 1 << d->al, m1 = (int)(~0u << d->al);
    int k = d->ss;
    if (d->eobrun == 0) {
        const Huff *ac = &d->ac[c->ta];
        for (; k <= d->se; k++) {
            int rs = decode_huff(d, ac);
            int r = rs >> 4, s = rs & 15;
            if (s) {
                if (s != 1) fail(d, "corrupt JPEG data: bad refinement value near byte %zu", d->pos);
                s = get_bits(d, 1) ? p1 : m1;
            } else if (r != 15) {
                d->eobrun = 1 << r;
                if (r) d->eobrun += (int)get_bits(d, r);
                break;
            }
            /* skip r zero coefficients, refining the nonzero ones passed */
            do {
                int16_t *coef = blk + natural_order[k];
                if (*coef != 0) {
                    refine_nonzero(d, coef, p1, m1);
                } else if (--r < 0) {
                    break;
                }
                k++;
            } while (k <= d->se);
            if (s) {
                if (k > d->se) fail(d, "corrupt JPEG data: refinement past the band near byte %zu", d->pos);
                blk[natural_order[k]] = (int16_t)s;
            }
        }
    }
    if (d->eobrun > 0) {
        for (; k <= d->se; k++) {
            int16_t *coef = blk + natural_order[k];
            if (*coef != 0) refine_nonzero(d, coef, p1, m1);
        }
        d->eobrun--;
    }
}

/* ---------------------------------------------------------------- scan */

static void restart(Dec *d, int *rst_num) {
    size_t at = d->marker_hit ? d->marker_pos : d->pos;
    d->pos = at;
    unsigned m = next_marker(d);
    if (m != 0xD0u + (unsigned)(*rst_num & 7))
        fail(d, "corrupt JPEG data: expected RST%d, found marker 0x%02X at byte %zu",
             *rst_num & 7, m, at);
    *rst_num = (*rst_num + 1) & 7;
    reset_bits(d);
    d->eobrun = 0;
    for (int i = 0; i < d->ncomp; i++) d->comp[i].dc_pred = 0;
}

static void read_sos(Dec *d) {
    if (!d->sof) fail(d, "corrupt JPEG: SOS before SOF at byte %zu", d->pos);
    unsigned len = get_u16(d);
    size_t end = d->pos + len - 2;
    d->ns = (int)get_u8(d);
    if (d->ns < 1 || d->ns > d->ncomp || len != 6 + 2 * (unsigned)d->ns)
        fail(d, "corrupt JPEG: bad SOS at byte %zu", d->pos);
    for (int i = 0; i < d->ns; i++) {
        unsigned id = get_u8(d), t = get_u8(d);
        int ci = -1;
        for (int j = 0; j < d->ncomp; j++)
            if (d->comp[j].id == (int)id) ci = j;
        if (ci < 0) fail(d, "corrupt JPEG: scan names an unknown component %u", id);
        for (int j = 0; j < i; j++)
            if (d->scomp[j] == ci) fail(d, "corrupt JPEG: a component twice in one scan");
        d->scomp[i] = ci;
        d->comp[ci].td = (int)(t >> 4);
        d->comp[ci].ta = (int)(t & 15);
        if (d->comp[ci].td > 3 || d->comp[ci].ta > 3) fail(d, "corrupt JPEG: bad table selector in SOS");
    }
    d->ss = (int)get_u8(d);
    d->se = (int)get_u8(d);
    unsigned a = get_u8(d);
    d->ah = (int)(a >> 4);
    d->al = (int)(a & 15);
    d->pos = end;
    if (d->progressive) {
        int bad = d->ss > d->se || d->se > 63 || d->al > 13 || (d->ss == 0 && d->se != 0) ||
                  (d->ss > 0 && d->ns != 1) || (d->ah != 0 && d->ah != d->al + 1);
        if (bad) fail(d, "corrupt JPEG: bad progression parameters in a scan");
    }
}

typedef void (*BlockFn)(Dec *, Comp *, int16_t *);

static void decode_scan(Dec *d) {
    BlockFn fn = decode_block_seq;
    int need_dc = 1, need_ac = 1;
    if (d->progressive) {
        if (d->ss == 0) fn = d->ah ? decode_dc_refine : decode_dc_first;
        else fn = d->ah ? decode_ac_refine : decode_ac_first;
        need_dc = d->ss == 0 && d->ah == 0;
        need_ac = d->ss > 0;
    }
    for (int i = 0; i < d->ns; i++) {
        Comp *c = &d->comp[d->scomp[i]];
        if (need_dc && !d->dc[c->td].present)
            fail(d, "JPEG scan uses DC Huffman table %d, which the file does not define", c->td);
        if (need_ac && !d->ac[c->ta].present)
            fail(d, "JPEG scan uses AC Huffman table %d, which the file does not define", c->ta);
        if (!c->latched) {
            if (!d->qt_present[c->tq])
                fail(d, "JPEG component uses quantization table %d, which the file does not define", c->tq);
            memcpy(c->q, d->qt[c->tq], sizeof(c->q));
            c->latched = 1;
        }
        c->scanned = 1;
        c->dc_pred = 0;
        if (d->progressive) {
            for (int k = d->ss; k <= d->se; k++) c->coef_bits[k] = d->al;
        }
    }
    reset_bits(d);
    d->eobrun = 0;
    int rst_num = 0;
    long todo = 0;
    if (d->ns == 1) {
        Comp *c = &d->comp[d->scomp[0]];
        for (int by = 0; by < c->bh; by++) {
            for (int bx = 0; bx < c->bw; bx++) {
                if (d->restart_interval && todo == d->restart_interval) {
                    restart(d, &rst_num);
                    todo = 0;
                }
                fn(d, c, c->coef + ((size_t)by * c->bw_alloc + bx) * 64);
                todo++;
            }
        }
    } else {
        for (int my = 0; my < d->mcuy; my++) {
            for (int mx = 0; mx < d->mcux; mx++) {
                if (d->restart_interval && todo == d->restart_interval) {
                    restart(d, &rst_num);
                    todo = 0;
                }
                for (int i = 0; i < d->ns; i++) {
                    Comp *c = &d->comp[d->scomp[i]];
                    for (int y = 0; y < c->v; y++)
                        for (int x = 0; x < c->h; x++) {
                            size_t b = (size_t)(my * c->v + y) * c->bw_alloc + (size_t)(mx * c->h + x);
                            fn(d, c, c->coef + b * 64);
                        }
                }
                todo++;
            }
        }
    }
    /* the marker after the scan (libjpeg skips what is left of the segment) */
    d->pos = d->marker_hit ? d->marker_pos : d->pos;
}

/* --------------------------------------------------------------- IDCT */

#define CONST_BITS 13
#define PASS1_BITS 2
#define FIX_0_298631336 ((int64_t)2446)
#define FIX_0_390180644 ((int64_t)3196)
#define FIX_0_541196100 ((int64_t)4433)
#define FIX_0_765366865 ((int64_t)6270)
#define FIX_0_899976223 ((int64_t)7373)
#define FIX_1_175875602 ((int64_t)9633)
#define FIX_1_501321110 ((int64_t)12299)
#define FIX_1_847759065 ((int64_t)15137)
#define FIX_1_961570560 ((int64_t)16069)
#define FIX_2_053119869 ((int64_t)16819)
#define FIX_2_562915447 ((int64_t)20995)
#define FIX_3_072711026 ((int64_t)25172)
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n) - 1))) >> (n))
#define RANGE_MASK 1023

/* jdmaster.c's prepare_range_limit_table: limit[x] = clamp(x) around
 * index 256; the IDCT's table starts CENTERJSAMPLE further in and wraps
 * (x & RANGE_MASK) */
static void build_range_table(uint8_t *table) {
    uint8_t *t = table + 256;
    memset(table, 0, 256);
    for (int i = 0; i < 256; i++) t[i] = (uint8_t)i;
    t += 128;
    for (int i = 128; i < 512; i++) t[i] = 255;
    memset(t + 512, 0, 512 - 128);
    memcpy(t + 1024 - 128, table + 256, 128);
}

static void idct_islow(const int16_t *in, const int32_t *q, const uint8_t *range_limit,
                       uint8_t *out, int stride) {
    int ws[64];
    for (int c = 0; c < 8; c++) {
        const int16_t *ip = in + c;
        const int32_t *qp = q + c;
        int *wp = ws + c;
        if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
            ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
            int dc = (int)((int64_t)ip[0] * qp[0] * (1 << PASS1_BITS));
            for (int r = 0; r < 8; r++) wp[8 * r] = dc;
            continue;
        }
        int64_t z1, z2, z3, z4, z5, t0, t1, t2, t3, t10, t11, t12, t13;
        z2 = (int64_t)ip[16] * qp[16];
        z3 = (int64_t)ip[48] * qp[48];
        z1 = (z2 + z3) * FIX_0_541196100;
        t2 = z1 + z3 * (-FIX_1_847759065);
        t3 = z1 + z2 * FIX_0_765366865;
        z2 = (int64_t)ip[0] * qp[0];
        z3 = (int64_t)ip[32] * qp[32];
        t0 = (z2 + z3) * (1 << CONST_BITS);
        t1 = (z2 - z3) * (1 << CONST_BITS);
        t10 = t0 + t3;
        t13 = t0 - t3;
        t11 = t1 + t2;
        t12 = t1 - t2;
        t0 = (int64_t)ip[56] * qp[56];
        t1 = (int64_t)ip[40] * qp[40];
        t2 = (int64_t)ip[24] * qp[24];
        t3 = (int64_t)ip[8] * qp[8];
        z1 = t0 + t3;
        z2 = t1 + t2;
        z3 = t0 + t2;
        z4 = t1 + t3;
        z5 = (z3 + z4) * FIX_1_175875602;
        t0 = t0 * FIX_0_298631336;
        t1 = t1 * FIX_2_053119869;
        t2 = t2 * FIX_3_072711026;
        t3 = t3 * FIX_1_501321110;
        z1 = z1 * (-FIX_0_899976223);
        z2 = z2 * (-FIX_2_562915447);
        z3 = z3 * (-FIX_1_961570560);
        z4 = z4 * (-FIX_0_390180644);
        z3 += z5;
        z4 += z5;
        t0 += z1 + z3;
        t1 += z2 + z4;
        t2 += z2 + z3;
        t3 += z1 + z4;
        wp[0] = (int)DESCALE(t10 + t3, CONST_BITS - PASS1_BITS);
        wp[56] = (int)DESCALE(t10 - t3, CONST_BITS - PASS1_BITS);
        wp[8] = (int)DESCALE(t11 + t2, CONST_BITS - PASS1_BITS);
        wp[48] = (int)DESCALE(t11 - t2, CONST_BITS - PASS1_BITS);
        wp[16] = (int)DESCALE(t12 + t1, CONST_BITS - PASS1_BITS);
        wp[40] = (int)DESCALE(t12 - t1, CONST_BITS - PASS1_BITS);
        wp[24] = (int)DESCALE(t13 + t0, CONST_BITS - PASS1_BITS);
        wp[32] = (int)DESCALE(t13 - t0, CONST_BITS - PASS1_BITS);
    }
    for (int r = 0; r < 8; r++) {
        const int *wp = ws + 8 * r;
        uint8_t *op = out + (size_t)r * stride;
        int64_t z1, z2, z3, z4, z5, t0, t1, t2, t3, t10, t11, t12, t13;
        z2 = wp[2];
        z3 = wp[6];
        z1 = (z2 + z3) * FIX_0_541196100;
        t2 = z1 + z3 * (-FIX_1_847759065);
        t3 = z1 + z2 * FIX_0_765366865;
        t0 = ((int64_t)wp[0] + wp[4]) * (1 << CONST_BITS);
        t1 = ((int64_t)wp[0] - wp[4]) * (1 << CONST_BITS);
        t10 = t0 + t3;
        t13 = t0 - t3;
        t11 = t1 + t2;
        t12 = t1 - t2;
        t0 = wp[7];
        t1 = wp[5];
        t2 = wp[3];
        t3 = wp[1];
        z1 = t0 + t3;
        z2 = t1 + t2;
        z3 = t0 + t2;
        z4 = t1 + t3;
        z5 = (z3 + z4) * FIX_1_175875602;
        t0 = t0 * FIX_0_298631336;
        t1 = t1 * FIX_2_053119869;
        t2 = t2 * FIX_3_072711026;
        t3 = t3 * FIX_1_501321110;
        z1 = z1 * (-FIX_0_899976223);
        z2 = z2 * (-FIX_2_562915447);
        z3 = z3 * (-FIX_1_961570560);
        z4 = z4 * (-FIX_0_390180644);
        z3 += z5;
        z4 += z5;
        t0 += z1 + z3;
        t1 += z2 + z4;
        t2 += z2 + z3;
        t3 += z1 + z4;
        const int sh = CONST_BITS + PASS1_BITS + 3;
        op[0] = range_limit[(int)DESCALE(t10 + t3, sh) & RANGE_MASK];
        op[7] = range_limit[(int)DESCALE(t10 - t3, sh) & RANGE_MASK];
        op[1] = range_limit[(int)DESCALE(t11 + t2, sh) & RANGE_MASK];
        op[6] = range_limit[(int)DESCALE(t11 - t2, sh) & RANGE_MASK];
        op[2] = range_limit[(int)DESCALE(t12 + t1, sh) & RANGE_MASK];
        op[5] = range_limit[(int)DESCALE(t12 - t1, sh) & RANGE_MASK];
        op[3] = range_limit[(int)DESCALE(t13 + t0, sh) & RANGE_MASK];
        op[4] = range_limit[(int)DESCALE(t13 - t0, sh) & RANGE_MASK];
    }
}

static void idct_component(Dec *d, Comp *c) {
    int stride = c->bw * 8;
    c->plane = (uint8_t *)malloc((size_t)stride * c->bh * 8);
    if (!c->plane) fail(d, "out of memory for a %dx%d JPEG", d->width, d->height);
    for (int by = 0; by < c->bh; by++)
        for (int bx = 0; bx < c->bw; bx++)
            idct_islow(c->coef + ((size_t)by * c->bw_alloc + bx) * 64, c->q, d->range + 384,
                       c->plane + (size_t)by * 8 * stride + (size_t)bx * 8, stride);
}

/* ---------------------------------------------------------- upsample */

/* Output row y of component c at full resolution into row (>= width
 * samples, and room for 2 * cw). */
static void upsample_row(const Dec *d, const Comp *c, int y, uint8_t *row) {
    int he = d->hmax / c->h, ve = d->vmax / c->v, stride = c->bw * 8, cw = c->cw;
    if (he == 1 && ve == 1) {
        memcpy(row, c->plane + (size_t)y * stride, (size_t)cw);
        return;
    }
    int iy = y / ve;
    const uint8_t *rn = c->plane + (size_t)iy * stride;
    if (ve == 2 && (he == 1 || (he == 2 && cw > 2))) {
        /* triangle filter: 3/4 nearer row + 1/4 the row above (even output
         * rows) or below (odd), replicated at the top and bottom */
        int odd = y & 1;
        int fy = odd ? (iy + 1 < c->ch ? iy + 1 : c->ch - 1) : (iy > 0 ? iy - 1 : 0);
        const uint8_t *rf = c->plane + (size_t)fy * stride;
        if (he == 1) {
            int bias = odd ? 2 : 1;
            for (int x = 0; x < cw; x++) row[x] = (uint8_t)((rn[x] * 3 + rf[x] + bias) >> 2);
            return;
        }
        int last = rn[0] * 3 + rf[0], this_ = last, next;
        for (int x = 0; x < cw; x++) {
            next = x + 1 < cw ? rn[x + 1] * 3 + rf[x + 1] : this_;
            row[2 * x] = (uint8_t)((this_ * 3 + last + 8) >> 4);
            row[2 * x + 1] = (uint8_t)((this_ * 3 + next + 7) >> 4);
            last = this_;
            this_ = next;
        }
        return;
    }
    if (he == 2 && ve == 1 && cw > 2) {
        for (int x = 0; x < cw; x++) {
            int v3 = rn[x] * 3;
            int l = rn[x > 0 ? x - 1 : 0], r = rn[x + 1 < cw ? x + 1 : x];
            row[2 * x] = (uint8_t)((v3 + l + 1) >> 2);
            row[2 * x + 1] = (uint8_t)((v3 + r + 2) >> 2);
        }
        return;
    }
    for (int x = 0; x < cw * he; x++) row[x] = rn[x / he];
}

/* ------------------------------------------------------------- colour */

#define SCALEBITS 16
#define ONE_HALF ((int64_t)1 << (SCALEBITS - 1))
#define FIX(x) ((int64_t)((x) * (1L << SCALEBITS) + 0.5))

static void build_color_tables(Dec *d) {
    for (int i = 0, x = -128; i < 256; i++, x++) {
        d->cr_r[i] = (int)((FIX(1.40200) * x + ONE_HALF) >> SCALEBITS);
        d->cb_b[i] = (int)((FIX(1.77200) * x + ONE_HALF) >> SCALEBITS);
        d->cr_g[i] = -FIX(0.71414) * x;
        d->cb_g[i] = -FIX(0.34414) * x + ONE_HALF;
    }
}

/* ---------------------------------------------------------------- API */

static void parse_until_scan(Dec *d, int decode) {
    if (d->n < 2 || d->data[0] != 0xFF || d->data[1] != 0xD8) fail(d, "not a JPEG file (no SOI marker)");
    d->pos = 2;
    int eoi = 0;
    while (!eoi) {
        unsigned m = next_marker(d);
        if ((m >= 0xC0 && m <= 0xCF) && m != 0xC4 && m != 0xC8 && m != 0xCC) {
            read_sof(d, m);
            if (decode) allocate(d);
            continue;
        }
        switch (m) {
        case 0xD8:
            fail(d, "corrupt JPEG: a second SOI marker at byte %zu", d->pos);
            break;
        case 0xD9:
            eoi = 1;
            break;
        case 0xDA:
            read_sos(d);
            if (!decode) return;
            decode_scan(d);
            break;
        case 0xCC:
            fail(d, "arithmetic-coded JPEG (DAC marker) is not supported");
            break;
        case 0xDC:
            fail(d, "JPEG with a DNL marker is not supported");
            break;
        case 0xD0: case 0xD1: case 0xD2: case 0xD3:
        case 0xD4: case 0xD5: case 0xD6: case 0xD7: case 0x01:
            break;  /* parameterless; libjpeg ignores a stray RST too */
        default: {
            if (!(m == 0xC4 || m == 0xDB || m == 0xDD || m == 0xFE || (m >= 0xE0 && m <= 0xEF)))
                fail(d, "corrupt JPEG: unknown marker 0x%02X at byte %zu", m, d->pos - 2);
            size_t at = d->pos;
            unsigned len = get_u16(d);
            if (len < 2 || at + len > d->n) truncated(d, d->n);
            size_t end = at + len;
            if (m == 0xC4) read_dht(d, end);
            else if (m == 0xDB) read_dqt(d, end);
            else if (m == 0xDD) d->restart_interval = (int)get_u16(d);
            else if (m >= 0xE0 && m <= 0xEF) read_app(d, m, end);
            if (d->pos > end) fail(d, "corrupt JPEG: marker 0x%02X overruns its length", m);
            d->pos = end;
        }
        }
    }
    if (!d->sof) fail(d, "corrupt JPEG: no SOF marker before EOI");
    if (!decode) fail(d, "corrupt JPEG: no scan before EOI");
}

static void free_dec(Dec *d) {
    for (int i = 0; i < MAX_COMPS; i++) {
        free(d->comp[i].coef);
        free(d->comp[i].plane);
    }
}

static int rgb_source(const Dec *d) {
    if (d->ncomp != 3) return 0;
    if (d->saw_jfif) return 0;
    if (d->saw_adobe) return d->adobe_transform == 0;
    return d->comp[0].id == 'R' && d->comp[1].id == 'G' && d->comp[2].id == 'B';
}

static void output(Dec *d, uint8_t *out) {
    int w = d->width, h = d->height;
    /* destination pixel of source (sy, sx): base + sy * ystep + sx * xstep */
    long base = 0, xs = 1, ys = w;
    switch (d->orientation) {
    case 2: base = w - 1; xs = -1; ys = w; break;
    case 3: base = (long)(h - 1) * w + w - 1; xs = -1; ys = -w; break;
    case 4: base = (long)(h - 1) * w; xs = 1; ys = -w; break;
    case 5: base = 0; xs = h; ys = 1; break;
    case 6: base = h - 1; xs = h; ys = -1; break;
    case 7: base = (long)(w - 1) * h + h - 1; xs = -h; ys = -1; break;
    case 8: base = (long)(w - 1) * h; xs = -h; ys = 1; break;
    default: break;
    }
    size_t rowlen = (size_t)d->mcux * d->hmax * 8 + 16;
    uint8_t *rows = (uint8_t *)malloc(rowlen * 3);
    if (!rows) fail(d, "out of memory for a %dx%d JPEG", w, h);
    uint8_t *r0 = rows, *r1 = rows + rowlen, *r2 = rows + 2 * rowlen;
    int rgb = rgb_source(d);
    for (int y = 0; y < h; y++) {
        upsample_row(d, &d->comp[0], y, r0);
        if (d->ncomp == 3) {
            upsample_row(d, &d->comp[1], y, r1);
            upsample_row(d, &d->comp[2], y, r2);
        }
        const uint8_t *limit = d->range + 256;  /* the clamp of ycc_rgb_convert */
        long at = base + (long)y * ys;
        for (int x = 0; x < w; x++, at += xs) {
            uint8_t *dst = out + 3 * at;
            if (d->ncomp == 1) {
                dst[0] = dst[1] = dst[2] = r0[x];
            } else if (rgb) {
                dst[0] = r0[x];
                dst[1] = r1[x];
                dst[2] = r2[x];
            } else {
                int yy = r0[x], cb = r1[x], cr = r2[x];
                dst[0] = limit[yy + d->cr_r[cr]];
                dst[1] = limit[yy + (int)((d->cb_g[cb] + d->cr_g[cr]) >> SCALEBITS)];
                dst[2] = limit[yy + d->cb_b[cb]];
            }
        }
    }
    free(rows);
}

int jpeg_info(const uint8_t *data, size_t n, int *info, char *err, int errlen) {
    Dec *d = (Dec *)calloc(1, sizeof(Dec));
    if (!d) {
        snprintf(err, (size_t)errlen, "out of memory");
        return -1;
    }
    d->data = data;
    d->n = n;
    d->err = err;
    d->errlen = errlen;
    int rc = -1;
    if (setjmp(d->fail) == 0) {
        parse_until_scan(d, 0);
        int swap = d->orientation >= 5;
        info[0] = swap ? d->height : d->width;
        info[1] = swap ? d->width : d->height;
        info[2] = d->ncomp;
        info[3] = d->orientation ? d->orientation : 1;
        rc = 0;
    }
    free(d);
    return rc;
}

int jpeg_decode(const uint8_t *data, size_t n, uint8_t *out, size_t out_bytes, char *err, int errlen) {
    Dec *d = (Dec *)calloc(1, sizeof(Dec));
    if (!d) {
        snprintf(err, (size_t)errlen, "out of memory");
        return -1;
    }
    d->data = data;
    d->n = n;
    d->err = err;
    d->errlen = errlen;
    int rc = -1;
    if (setjmp(d->fail) == 0) {
        build_range_table(d->range);
        build_color_tables(d);
        parse_until_scan(d, 1);
        if ((size_t)d->width * d->height * 3 != out_bytes)
            fail(d, "output buffer of %zu bytes for a %dx%d image", out_bytes, d->width, d->height);
        for (int i = 0; i < d->ncomp; i++) {
            Comp *c = &d->comp[i];
            if (!c->scanned) fail(d, "truncated JPEG: component %d has no scan", c->id);
            if (d->progressive && c->coef_bits[0] >= 0) {
                for (int k = 1; k < 10; k++)
                    if (c->coef_bits[k] != 0)
                        fail(d, "progressive JPEG whose scans leave coefficients unrefined "
                                "(libjpeg's block smoothing) is not supported");
            }
        }
        for (int i = 0; i < d->ncomp; i++) idct_component(d, &d->comp[i]);
        output(d, out);
        rc = 0;
    }
    free_dec(d);
    free(d);
    return rc;
}
