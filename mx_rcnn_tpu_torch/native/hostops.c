/* Host greedy NMS (the port's copy of cpu_nms in the JAX package's
 * native/hostops.c; the reference's rcnn/cython/cpu_nms.pyx role).
 *
 * Serves the host decode + NMS branch of eval (serve/runner.py ::
 * detections_from_output without the device postprocess), where the data
 * is already on the host as numpy.  Built with the host C compiler at first
 * use and bound with ctypes (native/hostops.py).
 *
 * Box convention: inclusive pixel coordinates, width = x2 - x1 + 1.
 */

#include <stdlib.h>

typedef struct {
    float score;
    int idx;
} score_idx;

static int cmp_score_desc(const void *a, const void *b) {
    float sa = ((const score_idx *)a)->score;
    float sb = ((const score_idx *)b)->score;
    if (sa < sb) return 1;
    if (sa > sb) return -1;
    /* tie-break on original index DESCENDING: the python oracle orders by
     * scores.argsort()[::-1], whose reversal puts equal scores in
     * reverse index order */
    return ((const score_idx *)b)->idx - ((const score_idx *)a)->idx;
}

/* dets: (n, 5) row-major [x1, y1, x2, y2, score]; keep: out buffer of
 * capacity n (kept indices, score-descending).  Returns #kept, or -1 on
 * allocation failure (the Python binding then takes the numpy path). */
int cpu_nms(const float *dets, int n, float thresh, int *keep) {
    if (n <= 0) return 0;
    score_idx *order = (score_idx *)malloc((size_t)n * sizeof(score_idx));
    float *areas = (float *)malloc((size_t)n * sizeof(float));
    char *dead = (char *)calloc((size_t)n, 1);
    int n_keep = 0;
    if (!order || !areas || !dead) {
        n_keep = -1;
        goto done;
    }

    for (int i = 0; i < n; i++) {
        const float *d = dets + 5 * i;
        order[i].score = d[4];
        order[i].idx = i;
        areas[i] = (d[2] - d[0] + 1.0f) * (d[3] - d[1] + 1.0f);
    }
    qsort(order, (size_t)n, sizeof(score_idx), cmp_score_desc);

    for (int oi = 0; oi < n; oi++) {
        int i = order[oi].idx;
        if (dead[i]) continue;
        keep[n_keep++] = i;
        const float *di = dets + 5 * i;
        for (int oj = oi + 1; oj < n; oj++) {
            int j = order[oj].idx;
            if (dead[j]) continue;
            const float *dj = dets + 5 * j;
            float xx1 = di[0] > dj[0] ? di[0] : dj[0];
            float yy1 = di[1] > dj[1] ? di[1] : dj[1];
            float xx2 = di[2] < dj[2] ? di[2] : dj[2];
            float yy2 = di[3] < dj[3] ? di[3] : dj[3];
            float w = xx2 - xx1 + 1.0f;
            float h = yy2 - yy1 + 1.0f;
            if (w <= 0.0f || h <= 0.0f) continue;
            float inter = w * h;
            float ovr = inter / (areas[i] + areas[j] - inter);
            if (ovr > thresh) dead[j] = 1;
        }
    }
done:
    free(order);
    free(areas);
    free(dead);
    return n_keep;
}
