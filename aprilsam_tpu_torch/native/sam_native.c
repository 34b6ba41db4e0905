/* Native runtime kernels for aprilsam_tpu.
 *
 * The reference implements its entire runtime in C; this module provides the
 * TPU-native framework's host-side runtime: symbolic analysis (constrained
 * minimum-degree ordering, block symbolic factorization / elimination tree)
 * and the small-problem batch epoch (factor evaluation, normal-equation
 * assembly, block-sparse right-looking Cholesky, triangular solves) in
 * float64.  At M3500 scale the numeric factorization is ~10 MFLOP — far
 * below accelerator launch overhead — so batch epochs run here while the
 * per-update hot path (frontal QR + solves) runs on the TPU.  Functional
 * behavior mirrors april_graph_cholesky (reference: aprilsam.c:87-375) with
 * one Gauss-Newton step per epoch in double precision.
 *
 * All interfaces are flat C arrays for ctypes; no Python objects.
 */

#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define RESTRICT restrict

/* ------------------------------------------------------------------ */
/* Constrained minimum-degree ordering                                  */
/*                                                                      */
/* Exact minimum degree with lazy re-evaluation over an explicit        */
/* neighbor-set representation; the newest node (id n-1) is forced to   */
/* be eliminated last, matching the reference's bias that keeps fresh   */
/* poses at the elimination-tree root (aprilsam.c:1020-1035).           */
/* ------------------------------------------------------------------ */

typedef struct {
    int32_t *items;
    int32_t n, cap;
} vec_t;

static void vec_init(vec_t *v, int cap) {
    if (cap < 4) cap = 4;
    v->items = (int32_t *)malloc(sizeof(int32_t) * cap);
    v->n = 0;
    v->cap = cap;
}

static void vec_push(vec_t *v, int32_t x) {
    if (v->n == v->cap) {
        v->cap *= 2;
        v->items = (int32_t *)realloc(v->items, sizeof(int32_t) * v->cap);
    }
    v->items[v->n++] = x;
}

/* binary min-heap of (key, node) */
typedef struct {
    int64_t *key;
    int32_t *node;
    int32_t n;
} heap_t;

static void heap_push(heap_t *h, int64_t key, int32_t node) {
    int i = h->n++;
    while (i > 0) {
        int p = (i - 1) / 2;
        if (h->key[p] <= key) break;
        h->key[i] = h->key[p];
        h->node[i] = h->node[p];
        i = p;
    }
    h->key[i] = key;
    h->node[i] = node;
}

static int heap_pop(heap_t *h, int64_t *key, int32_t *node) {
    if (h->n == 0) return 0;
    *key = h->key[0];
    *node = h->node[0];
    h->n--;
    int64_t k = h->key[h->n];
    int32_t v = h->node[h->n];
    int i = 0;
    for (;;) {
        int l = 2 * i + 1, r = l + 1, m = i;
        int64_t mk = k;
        if (l < h->n && h->key[l] < mk) { m = l; mk = h->key[l]; }
        if (r < h->n && h->key[r] < mk) { m = r; }
        if (m == i) break;
        h->key[i] = h->key[m];
        h->node[i] = h->node[m];
        i = m;
    }
    h->key[i] = k;
    h->node[i] = v;
    return 1;
}

/* adjacency is CSR: adj_ptr[n+1], adj_idx[adj_ptr[n]] (no self loops) */
int asn_order_md(int32_t n, const int32_t *adj_ptr, const int32_t *adj_idx,
                 int32_t *order_out)
{
    if (n <= 0) return 0;
    if (n == 1) { order_out[0] = 0; return 0; }

    vec_t *nbr = (vec_t *)malloc(sizeof(vec_t) * n);
    uint8_t *dead = (uint8_t *)calloc(n, 1);
    int32_t *mark = (int32_t *)calloc(n, sizeof(int32_t));
    int32_t token = 0;

    for (int i = 0; i < n; i++) {
        int deg = adj_ptr[i + 1] - adj_ptr[i];
        vec_init(&nbr[i], deg + 4);
        for (int k = adj_ptr[i]; k < adj_ptr[i + 1]; k++) {
            int32_t j = adj_idx[k];
            if (j != i && j != n - 1)  /* newest node removed from the game */
                vec_push(&nbr[i], j);
        }
    }

    heap_t h;
    h.key = (int64_t *)malloc(sizeof(int64_t) * 4 * n);
    h.node = (int32_t *)malloc(sizeof(int32_t) * 4 * n);
    h.n = 0;
    int heap_cap = 4 * n;
    for (int i = 0; i < n - 1; i++) heap_push(&h, nbr[i].n, i);

    int k_out = 0;
    int64_t key;
    int32_t i;
    while (heap_pop(&h, &key, &i)) {
        if (dead[i]) continue;
        if ((int64_t)nbr[i].n > key) {  /* stale: re-queue */
            if (h.n + 1 > heap_cap) {
                heap_cap *= 2;
                h.key = (int64_t *)realloc(h.key, sizeof(int64_t) * heap_cap);
                h.node = (int32_t *)realloc(h.node, sizeof(int32_t) * heap_cap);
            }
            heap_push(&h, nbr[i].n, i);
            continue;
        }
        order_out[k_out++] = i;
        dead[i] = 1;
        /* marginalize: connect all live neighbors pairwise */
        vec_t *ni = &nbr[i];
        /* compact live neighbors in place */
        int live = 0;
        for (int a = 0; a < ni->n; a++)
            if (!dead[ni->items[a]]) ni->items[live++] = ni->items[a];
        ni->n = live;
        for (int a = 0; a < live; a++) {
            int32_t na = ni->items[a];
            vec_t *va = &nbr[na];
            token++;
            int w = 0;
            for (int t = 0; t < va->n; t++) {
                int32_t u = va->items[t];
                if (u == i || dead[u]) continue;
                va->items[w++] = u;
                mark[u] = token;
            }
            va->n = w;
            mark[na] = token;
            for (int b = 0; b < live; b++) {
                int32_t nb = ni->items[b];
                if (mark[nb] != token) {
                    vec_push(va, nb);
                    mark[nb] = token;
                }
            }
            if (h.n + 1 > heap_cap) {
                heap_cap *= 2;
                h.key = (int64_t *)realloc(h.key, sizeof(int64_t) * heap_cap);
                h.node = (int32_t *)realloc(h.node, sizeof(int32_t) * heap_cap);
            }
            heap_push(&h, va->n, na);
        }
    }
    order_out[k_out++] = n - 1;

    for (int t = 0; t < n; t++) free(nbr[t].items);
    free(nbr);
    free(dead);
    free(mark);
    free(h.key);
    free(h.node);
    return (k_out == n) ? 0 : -1;
}

/* ------------------------------------------------------------------ */
/* Block symbolic factorization                                         */
/*                                                                      */
/* Row-merge elimination at node (3x3 block) granularity over the       */
/* permuted adjacency: pattern(parent) |= pattern(row) \ {row}.         */
/* Equivalent to cs_schol's etree/column-count analysis                 */
/* (csparse.c:906-935, 1693-1716) expressed blockwise.                  */
/* Outputs padded patterns [n, bcap] (sentinel = n), counts, parents.   */
/* Returns max row nnz, or -1 on bcap overflow.                         */
/* ------------------------------------------------------------------ */

int asn_symbolic(int32_t n, const int32_t *adj_ptr, const int32_t *adj_idx,
                 const int32_t *order, int32_t bcap,
                 int32_t *patterns_out, int32_t *nnz_out, int32_t *parents_out)
{
    int32_t *pos = (int32_t *)malloc(sizeof(int32_t) * n);
    for (int p = 0; p < n; p++) pos[order[p]] = p;

    /* rows as growable sorted-on-demand sets; use mark-based merge */
    vec_t *rows = (vec_t *)malloc(sizeof(vec_t) * n);
    for (int p = 0; p < n; p++) vec_init(&rows[p], 8);
    int32_t *mark = (int32_t *)calloc(n, sizeof(int32_t));
    int32_t token = 0;

    for (int i = 0; i < n; i++) {
        int p = pos[i];
        vec_push(&rows[p], p);
        for (int k = adj_ptr[i]; k < adj_ptr[i + 1]; k++) {
            int q = pos[adj_idx[k]];
            if (q > p) vec_push(&rows[p], q);
        }
    }

    int maxnnz = 0;
    for (int p = 0; p < n; p++) {
        /* dedup current row */
        vec_t *r = &rows[p];
        token++;
        int w = 0;
        for (int t = 0; t < r->n; t++) {
            int32_t c = r->items[t];
            if (mark[c] != token) { mark[c] = token; r->items[w++] = c; }
        }
        r->n = w;
        /* sort ascending (rows are short; insertion sort) */
        for (int a = 1; a < r->n; a++) {
            int32_t x = r->items[a];
            int b = a - 1;
            while (b >= 0 && r->items[b] > x) { r->items[b + 1] = r->items[b]; b--; }
            r->items[b + 1] = x;
        }
        if (r->n > bcap) {
            for (int t = 0; t < n; t++) free(rows[t].items);
            free(rows); free(mark); free(pos);
            return -1;
        }
        parents_out[p] = (r->n > 1) ? r->items[1] : -1;
        if (r->n > 1) {
            vec_t *par = &rows[r->items[1]];
            for (int t = 1; t < r->n; t++) vec_push(par, r->items[t]);
        }
        nnz_out[p] = r->n;
        if (r->n > maxnnz) maxnnz = r->n;
        for (int t = 0; t < bcap; t++)
            patterns_out[(size_t)p * bcap + t] = (t < r->n) ? r->items[t] : n;
    }

    for (int t = 0; t < n; t++) free(rows[t].items);
    free(rows);
    free(mark);
    free(pos);
    return maxnnz;
}

/* ------------------------------------------------------------------ */
/* Factor evaluation + assembly + block-sparse Cholesky + solves        */
/* ------------------------------------------------------------------ */

static double mod2pi(double v)
{
    double w = v + M_PI;
    return (w - 2.0 * M_PI * floor(w / (2.0 * M_PI))) - M_PI;
}

/* find slot of column c in row p's pattern (binary search) */
static inline int slot_of(const int32_t *pat, int nnz, int32_t c)
{
    int lo = 0, hi = nnz - 1;
    while (lo <= hi) {
        int mid = (lo + hi) >> 1;
        int32_t v = pat[mid];
        if (v == c) return mid;
        if (v < c) lo = mid + 1; else hi = mid - 1;
    }
    return -1;
}

/* R storage: blocks[(p*bcap + s)*9 + i*3 + j] is scalar (i,j) of the block
 * at block-row p, slot s (column patterns[p*bcap+s]).  Upper block rows. */

/* Batch epoch.  Inputs:
 *  n nodes; states[n*3] current states (= linearization points after the
 *  relinearize-all step, aprilsam.c:131-135);
 *  xyt factors: fa, fb, fz[3], fW[9] per factor (nf of them);
 *  xytpos: pn, pz[3], pW[9] (np of them);
 *  ordering order[n] (+ pos implied), patterns/nnz (symbolic, scalar-free);
 *  tikhonov.
 * Outputs:
 *  blocks (R), y[3n], x[3n], new_states[n*3], delta[n*3], chi2_out[1].
 * Returns 0, or -1 if a diagonal pivot is not positive (non-SPD).
 */
int asn_batch_solve(
    int32_t n,
    const double *states,
    int32_t nf, const int32_t *fa, const int32_t *fb,
    const double *fz, const double *fW,
    int32_t np_, const int32_t *pn, const double *pz, const double *pW,
    const int32_t *order, int32_t bcap,
    const int32_t *patterns, const int32_t *nnz,
    double tikhonov,
    double *RESTRICT blocks, double *RESTRICT y, double *RESTRICT x,
    double *RESTRICT new_states, double *RESTRICT delta, double *chi2_out)
{
    int32_t *pos = (int32_t *)malloc(sizeof(int32_t) * n);
    for (int p = 0; p < n; p++) pos[order[p]] = p;

    size_t nb = (size_t)n * bcap * 9;
    memset(blocks, 0, nb * sizeof(double));
    double *B = (double *)calloc((size_t)3 * n, sizeof(double));

    /* scatter-add a 3x3 into block (pr, pc) of the upper pattern, following
     * the reference's keep-upper-scalars rule (aprilsam.c:169-178) */
    #define ADD_BLOCK(pr, pc, H) do {                                        \
        int _pr = (pr), _pc = (pc);                                          \
        if (_pr <= _pc) {                                                    \
            int _s = slot_of(&patterns[(size_t)_pr * bcap], nnz[_pr], _pc);  \
            double *_b = &blocks[((size_t)_pr * bcap + _s) * 9];             \
            if (_pr == _pc) {                                                \
                /* diagonal block: keep upper scalars of H, mirror */        \
                for (int _i = 0; _i < 3; _i++)                               \
                    for (int _j = _i; _j < 3; _j++) {                        \
                        _b[_i * 3 + _j] += (H)[_i * 3 + _j];                 \
                        if (_i != _j) _b[_j * 3 + _i] += (H)[_i * 3 + _j];   \
                    }                                                        \
            } else {                                                         \
                for (int _i = 0; _i < 9; _i++) _b[_i] += (H)[_i];            \
            }                                                                \
        }                                                                    \
        /* lower block (pr > pc) discarded: its mirror comes from the upper  \
         * block of the swapped pair */                                      \
    } while (0)

    double chi2 = 0.0;

    for (int f = 0; f < nf; f++) {
        int a = fa[f], b = fb[f];
        const double *z = &fz[(size_t)f * 3];
        const double *W = &fW[(size_t)f * 9];
        double xa = states[a * 3], ya = states[a * 3 + 1], ta = states[a * 3 + 2];
        double xb = states[b * 3], yb = states[b * 3 + 1], tb = states[b * 3 + 2];
        double ca = cos(ta), sa = sin(ta);
        double dx = xb - xa, dy = yb - ya;
        double zh0 = ca * dx + sa * dy, zh1 = -sa * dx + ca * dy, zh2 = tb - ta;
        double r[3] = { z[0] - zh0, z[1] - zh1, mod2pi(z[2] - zh2) };
        /* analytic Jacobians (april_graph_xyt.c:90-100) */
        double Ja[9] = { -ca, -sa, -sa * dx + ca * dy,
                          sa, -ca, -ca * dx - sa * dy,
                           0,   0, -1 };
        double Jb[9] = {  ca,  sa, 0,
                         -sa,  ca, 0,
                           0,   0, 1 };
        /* JtW = J^T W  (W used exactly as stored) */
        double JaW[9], JbW[9];
        for (int i = 0; i < 3; i++)
            for (int j = 0; j < 3; j++) {
                double s1 = 0, s2 = 0;
                for (int k = 0; k < 3; k++) {
                    s1 += Ja[k * 3 + i] * W[k * 3 + j];
                    s2 += Jb[k * 3 + i] * W[k * 3 + j];
                }
                JaW[i * 3 + j] = s1;
                JbW[i * 3 + j] = s2;
            }
        double Haa[9], Hab[9], Hba[9], Hbb[9];
        for (int i = 0; i < 3; i++)
            for (int j = 0; j < 3; j++) {
                double saa = 0, sab = 0, sba = 0, sbb = 0;
                for (int k = 0; k < 3; k++) {
                    saa += JaW[i * 3 + k] * Ja[k * 3 + j];
                    sab += JaW[i * 3 + k] * Jb[k * 3 + j];
                    sba += JbW[i * 3 + k] * Ja[k * 3 + j];
                    sbb += JbW[i * 3 + k] * Jb[k * 3 + j];
                }
                Haa[i * 3 + j] = saa; Hab[i * 3 + j] = sab;
                Hba[i * 3 + j] = sba; Hbb[i * 3 + j] = sbb;
            }
        int pa = pos[a], pb = pos[b];
        ADD_BLOCK(pa, pa, Haa);
        ADD_BLOCK(pa, pb, Hab);
        ADD_BLOCK(pb, pa, Hba);
        ADD_BLOCK(pb, pb, Hbb);
        for (int i = 0; i < 3; i++) {
            double ga = 0, gb2 = 0;
            for (int k = 0; k < 3; k++) {
                ga += JaW[i * 3 + k] * r[k];
                gb2 += JbW[i * 3 + k] * r[k];
            }
            B[pa * 3 + i] += ga;
            B[pb * 3 + i] += gb2;
        }
        double Wr[3];
        for (int i = 0; i < 3; i++)
            Wr[i] = W[i * 3] * r[0] + W[i * 3 + 1] * r[1] + W[i * 3 + 2] * r[2];
        chi2 += 0.5 * (r[0] * Wr[0] + r[1] * Wr[1] + r[2] * Wr[2]);
    }

    for (int f = 0; f < np_; f++) {
        int a = pn[f];
        const double *z = &pz[(size_t)f * 3];
        const double *W = &pW[(size_t)f * 9];
        double r[3] = { z[0] - states[a * 3], z[1] - states[a * 3 + 1],
                        mod2pi(z[2] - states[a * 3 + 2]) };
        int pa = pos[a];
        ADD_BLOCK(pa, pa, W);
        for (int i = 0; i < 3; i++) {
            double g = W[i * 3] * r[0] + W[i * 3 + 1] * r[1] + W[i * 3 + 2] * r[2];
            B[pa * 3 + i] += g;
        }
        double Wr[3];
        for (int i = 0; i < 3; i++)
            Wr[i] = W[i * 3] * r[0] + W[i * 3 + 1] * r[1] + W[i * 3 + 2] * r[2];
        chi2 += r[0] * Wr[0] + r[1] * Wr[1] + r[2] * Wr[2];
    }

    /* tikhonov on the diagonal (aprilsam.c:197-204) */
    for (int p = 0; p < n; p++) {
        double *d = &blocks[(size_t)p * bcap * 9];
        d[0] += tikhonov;
        d[4] += tikhonov;
        d[8] += tikhonov;
    }

    /* ---- block-sparse right-looking Cholesky on the static pattern.
     * Each block row is a dense strip S_p [3 x 3*nnz_p]; eliminate the
     * three scalar rows in-strip, then apply block updates
     * A[c_a, c_b] -= R_p[a]^T R_p[b] for all slot pairs 1 <= a <= b
     * (the reference does the same rank updates row-by-row via
     * svecd_add_i0_x, smatd.c:642-702). */
    int spd = 1;
    for (int p = 0; p < n; p++) {
        const int32_t *pat = &patterns[(size_t)p * bcap];
        int m = nnz[p];
        double *strip = &blocks[(size_t)p * bcap * 9];
        /* scalar elimination within the strip: rows r = 0..2 */
        for (int r = 0; r < 3; r++) {
            double d = strip[r * 3 + r]; /* block 0 is diagonal */
            if (d <= 0) { spd = 0; d = 1e-12; }
            d = sqrt(d);
            double inv = 1.0 / d;
            /* scale row r across the strip (cols >= r of block 0, all of
             * later blocks) */
            strip[r * 3 + r] = d;
            for (int c = r + 1; c < 3; c++) strip[r * 3 + c] *= inv;
            for (int s = 1; s < m; s++)
                for (int c = 0; c < 3; c++)
                    strip[(size_t)s * 9 + r * 3 + c] *= inv;
            /* update later scalar rows within the strip */
            for (int r2 = r + 1; r2 < 3; r2++) {
                double f0 = strip[r * 3 + r2]; /* element (r, r2) of diag blk */
                if (f0 == 0.0) continue;
                for (int c = r2; c < 3; c++)
                    strip[r2 * 3 + c] -= f0 * strip[r * 3 + c];
                for (int s = 1; s < m; s++)
                    for (int c = 0; c < 3; c++)
                        strip[(size_t)s * 9 + r2 * 3 + c] -=
                            f0 * strip[(size_t)s * 9 + r * 3 + c];
            }
        }
        /* zero the strictly-lower scalars of the diagonal block: the device
         * kernels consume blocks as full 3x3 matrices */
        strip[3] = 0.0;
        strip[6] = 0.0;
        strip[7] = 0.0;
        /* block updates to later rows */
        for (int a = 1; a < m; a++) {
            int32_t ca = pat[a];
            const int32_t *cpat = &patterns[(size_t)ca * bcap];
            int cn = nnz[ca];
            const double *Ra = &strip[(size_t)a * 9];
            for (int b = a; b < m; b++) {
                int32_t cb = pat[b];
                int ts = slot_of(cpat, cn, cb);
                if (ts < 0) continue;  /* structurally impossible, but safe */
                double *T = &blocks[((size_t)ca * bcap + ts) * 9];
                const double *Rb = &strip[(size_t)b * 9];
                /* T -= Ra^T Rb */
                for (int i = 0; i < 3; i++)
                    for (int j = 0; j < 3; j++) {
                        double s2 = 0;
                        for (int k = 0; k < 3; k++)
                            s2 += Ra[k * 3 + i] * Rb[k * 3 + j];
                        T[i * 3 + j] -= s2;
                    }
            }
        }
    }

    /* forward solve R^T y = B (smatd_ltransposetriangle_solve, smatd.c:1051) */
    memcpy(y, B, sizeof(double) * 3 * n);
    for (int p = 0; p < n; p++) {
        const int32_t *pat = &patterns[(size_t)p * bcap];
        int m = nnz[p];
        double *strip = &blocks[(size_t)p * bcap * 9];
        for (int r = 0; r < 3; r++) {
            int gi = p * 3 + r;
            double v = y[gi] / strip[r * 3 + r];
            y[gi] = v;
            for (int c = r + 1; c < 3; c++) y[p * 3 + c] -= v * strip[r * 3 + c];
            for (int s = 1; s < m; s++) {
                int gc = pat[s] * 3;
                for (int c = 0; c < 3; c++)
                    y[gc + c] -= v * strip[(size_t)s * 9 + r * 3 + c];
            }
        }
    }

    /* back substitution R x = y (smatd_utriangle_solve, smatd.c:1075) */
    for (int p = n - 1; p >= 0; p--) {
        const int32_t *pat = &patterns[(size_t)p * bcap];
        int m = nnz[p];
        double *strip = &blocks[(size_t)p * bcap * 9];
        for (int r = 2; r >= 0; r--) {
            double acc = y[p * 3 + r];
            for (int c = r + 1; c < 3; c++)
                acc -= strip[r * 3 + c] * x[p * 3 + c];
            for (int s = 1; s < m; s++) {
                int gc = pat[s] * 3;
                for (int c = 0; c < 3; c++)
                    acc -= strip[(size_t)s * 9 + r * 3 + c] * x[gc + c];
            }
            x[p * 3 + r] = acc / strip[r * 3 + r];
        }
    }

    /* state update (xyt_node_update, april_graph_xyt.c:302-314) */
    for (int i = 0; i < n; i++) {
        int p = pos[i];
        double dx0 = x[p * 3], dx1 = x[p * 3 + 1], dx2 = x[p * 3 + 2];
        if (isnan(dx0) || isnan(dx1) || isnan(dx2)) {
            new_states[i * 3] = states[i * 3];
            new_states[i * 3 + 1] = states[i * 3 + 1];
            new_states[i * 3 + 2] = states[i * 3 + 2];
            continue;
        }
        new_states[i * 3] = states[i * 3] + dx0;
        new_states[i * 3 + 1] = states[i * 3 + 1] + dx1;
        new_states[i * 3 + 2] = mod2pi(states[i * 3 + 2] + dx2);
        delta[i * 3] = dx0;
        delta[i * 3 + 1] = dx1;
        delta[i * 3 + 2] = dx2;
    }

    /* chi2 at the NEW states (april_graph_chi2, april_graph.c:79-98) */
    double c2 = 0.0;
    for (int f = 0; f < nf; f++) {
        int a = fa[f], b = fb[f];
        const double *z = &fz[(size_t)f * 3];
        const double *W = &fW[(size_t)f * 9];
        double xa = new_states[a * 3], ya = new_states[a * 3 + 1],
               ta = new_states[a * 3 + 2];
        double xb = new_states[b * 3], yb = new_states[b * 3 + 1],
               tb = new_states[b * 3 + 2];
        double ca = cos(ta), s1 = sin(ta);
        double dx = xb - xa, dy = yb - ya;
        double r[3] = { z[0] - (ca * dx + s1 * dy),
                        z[1] - (-s1 * dx + ca * dy),
                        mod2pi(z[2] - (tb - ta)) };
        double Wr[3];
        for (int i = 0; i < 3; i++)
            Wr[i] = W[i * 3] * r[0] + W[i * 3 + 1] * r[1] + W[i * 3 + 2] * r[2];
        c2 += 0.5 * (r[0] * Wr[0] + r[1] * Wr[1] + r[2] * Wr[2]);
    }
    for (int f = 0; f < np_; f++) {
        int a = pn[f];
        const double *z = &pz[(size_t)f * 3];
        const double *W = &pW[(size_t)f * 9];
        double r[3] = { z[0] - new_states[a * 3],
                        z[1] - new_states[a * 3 + 1],
                        mod2pi(z[2] - new_states[a * 3 + 2]) };
        double Wr[3];
        for (int i = 0; i < 3; i++)
            Wr[i] = W[i * 3] * r[0] + W[i * 3 + 1] * r[1] + W[i * 3 + 2] * r[2];
        c2 += r[0] * Wr[0] + r[1] * Wr[1] + r[2] * Wr[2];
    }
    chi2_out[0] = c2;

    free(pos);
    free(B);
    return spd ? 0 : -1;
}

/* ------------------------------------------------------------------ */
/* Incremental step planner (host symbolic hot path)                    */
/*                                                                      */
/* The per-step symbolic work — affected-set walk (aprilsam.c:482-498), */
/* pattern growth + parent re-derivation (the structural equivalent of  */
/* search_tree_append, aprilsam.c:958-987) and the fringe scan          */
/* (solve_node's pruned children, aprilsam.c:741-772) — on the padded   */
/* block-CSR arrays mirrored by the device (R_idx/R_nnz layout).        */
/* Replaces the python set/dict planner whose per-step constants        */
/* (~0.3 ms) exceeded the whole 5x-vs-C step budget.                    */
/*                                                                      */
/* State arrays are owned by python and updated in place:               */
/*   parents [ncap]        parent position or -1                        */
/*   pat_idx [ncap * bcap] sorted column positions, pat[p][0] == p,     */
/*                         sentinel fill == ncap                        */
/*   pat_nnz [ncap]                                                     */
/*   mark    [ncap]        visit stamps (zeroed once at creation)       */
/*   token   [1]           monotonically increasing stamp               */
/*                                                                      */
/* Returns 0 ok; 1 affected set > maxaff (no state mutated; caller      */
/* falls back to a batch epoch); 2 bcap overflow (caller grows);        */
/* 3 invariant violation (endpoint/parent not affected).                */
/* ------------------------------------------------------------------ */

/* O(1) child-list maintenance (doubly-linked: head per parent, prev/next
 * per child).  Lets the fringe scan below walk only the children of
 * affected rows instead of every position — the old O(nn) sweep was
 * ~0.1 ms/step at 100k poses, exactly the budget this planner exists to
 * save. */
static inline void asn_kid_unlink(int32_t c, int32_t old_par,
                                  int32_t *kid_head, int32_t *kid_next,
                                  int32_t *kid_prev)
{
    if (old_par < 0) return;
    int32_t prev = kid_prev[c], next = kid_next[c];
    if (prev >= 0) kid_next[prev] = next; else kid_head[old_par] = next;
    if (next >= 0) kid_prev[next] = prev;
    kid_prev[c] = -1;
    kid_next[c] = -1;
}

static inline void asn_kid_link(int32_t c, int32_t par,
                                int32_t *kid_head, int32_t *kid_next,
                                int32_t *kid_prev)
{
    if (par < 0) return;
    int32_t h = kid_head[par];
    kid_next[c] = h;
    kid_prev[c] = -1;
    if (h >= 0) kid_prev[h] = c;
    kid_head[par] = c;
}

int asn_plan_step(int32_t nn, int32_t ncap, int32_t bcap,
                  int32_t *RESTRICT parents,
                  int32_t *RESTRICT pat_idx,
                  int32_t *RESTRICT pat_nnz,
                  int32_t *RESTRICT mark, int32_t *RESTRICT token_io,
                  int32_t *RESTRICT kid_head,
                  int32_t *RESTRICT kid_next,
                  int32_t *RESTRICT kid_prev,
                  const int32_t *RESTRICT touched, int32_t nt,
                  const int32_t *RESTRICT ea, const int32_t *RESTRICT eb,
                  int32_t ne,
                  int32_t maxaff, int32_t fr_cap,
                  int32_t *RESTRICT F_out, int32_t *RESTRICT m_out,
                  int32_t *RESTRICT fringe_out, int32_t *RESTRICT nfr_out,
                  int32_t *RESTRICT old_idx_out, int32_t *RESTRICT old_nnz_out)
{
    (void)nn;
    int32_t token = ++token_io[0];
    int m = 0;

    /* 1. affected set: walk to root with the OLD parents (duplicate-safe
     * via stamps); bail before any mutation if it exceeds maxaff */
    for (int t = 0; t < nt; t++) {
        int32_t p = touched[t];
        while (p >= 0 && mark[p] != token) {
            mark[p] = token;
            if (m < maxaff) F_out[m] = p;
            m++;
            p = parents[p];
        }
    }
    m_out[0] = m;
    if (m > maxaff) return 1;

    /* ascending order (m is small; insertion sort) */
    for (int i = 1; i < m; i++) {
        int32_t v = F_out[i];
        int j = i - 1;
        while (j >= 0 && F_out[j] > v) { F_out[j + 1] = F_out[j]; j--; }
        F_out[j + 1] = v;
    }

    /* snapshot the PRE-merge patterns of the affected rows (they mirror the
     * device-resident R_idx): the superstep planner builds its front gather
     * table from these (slot of each resident column in the front) */
    for (int i = 0; i < m; i++) {
        int32_t p = F_out[i];
        memcpy(old_idx_out + (size_t)i * bcap, pat_idx + (size_t)p * bcap,
               sizeof(int32_t) * bcap);
        old_nnz_out[i] = pat_nnz[p];
    }

    /* 2. merge the new factor block edges into the affected rows */
    for (int e = 0; e < ne; e++) {
        if (eb[e] < 0) continue;            /* priors: diagonal only */
        int32_t lo = ea[e], hi = eb[e];
        if (lo > hi) { int32_t t = lo; lo = hi; hi = t; }
        if (mark[lo] != token || mark[hi] != token) return 3;
        int32_t *row = pat_idx + (size_t)lo * bcap;
        int32_t k = pat_nnz[lo];
        /* binary search for hi in row[0..k) */
        int a = 0, b = k;
        while (a < b) {
            int mid = (a + b) / 2;
            if (row[mid] < hi) a = mid + 1; else b = mid;
        }
        if (a < k && row[a] == hi) continue;  /* already present */
        if (k >= bcap) return 2;
        memmove(row + a + 1, row + a, sizeof(int32_t) * (k - a));
        row[a] = hi;
        pat_nnz[lo] = k + 1;
    }

    /* 3. restricted symbolic re-elimination over F ascending: re-derive
     * the parent (first super-diagonal column) and merge the row's
     * off-diagonal pattern into it (patterns only grow, growth stays
     * inside F because columns are etree ancestors) */
    int32_t *scratch = (int32_t *)malloc(sizeof(int32_t) * bcap);
    for (int i = 0; i < m; i++) {
        int32_t p = F_out[i];
        int32_t *row = pat_idx + (size_t)p * bcap;
        int32_t k = pat_nnz[p];
        int32_t parent = (k >= 2) ? row[1] : -1;
        if (parent != parents[p]) {
            asn_kid_unlink(p, parents[p], kid_head, kid_next, kid_prev);
            asn_kid_link(p, parent, kid_head, kid_next, kid_prev);
            parents[p] = parent;
        }
        if (parent < 0) continue;
        if (mark[parent] != token) { free(scratch); return 3; }
        /* sorted union: parent_row |= row[1:] */
        int32_t *prow = pat_idx + (size_t)parent * bcap;
        int32_t pk = pat_nnz[parent];
        int a = 1, b = 0, o = 0;          /* a over row[1:], b over prow */
        while (a < k && b < pk) {
            int32_t va = row[a], vb = prow[b];
            if (o >= bcap) { free(scratch); return 2; }
            if (va == vb)      { scratch[o++] = va; a++; b++; }
            else if (va < vb)  { scratch[o++] = va; a++; }
            else               { scratch[o++] = vb; b++; }
        }
        while (a < k) {
            if (o >= bcap) { free(scratch); return 2; }
            scratch[o++] = row[a++];
        }
        while (b < pk) {
            if (o >= bcap) { free(scratch); return 2; }
            scratch[o++] = prow[b++];
        }
        memcpy(prow, scratch, sizeof(int32_t) * o);
        for (int z = o; z < pk; z++) prow[z] = ncap;  /* re-pad shrink-safe */
        pat_nnz[parent] = o;
    }
    free(scratch);

    /* 4. fringe: positions outside F whose (new) parent is inside F.
     * Walk only the child lists of affected rows — O(|F| + fringe), not
     * O(nn). */
    int nfr = 0;
    for (int i = 0; i < m; i++) {
        int32_t p = F_out[i];
        for (int32_t c = kid_head[p]; c >= 0; c = kid_next[c]) {
            if (mark[c] == token) continue;
            if (nfr < fr_cap) fringe_out[nfr] = c;
            nfr++;
        }
    }
    /* ascending order (python-planner parity); past fr_cap the fringe is
     * unused — overflow forces the full path, which never reads it */
    if (nfr <= fr_cap) {
        for (int i = 1; i < nfr; i++) {
            int32_t v = fringe_out[i];
            int j = i - 1;
            while (j >= 0 && fringe_out[j] > v) {
                fringe_out[j + 1] = fringe_out[j];
                j--;
            }
            fringe_out[j + 1] = v;
        }
    }
    nfr_out[0] = nfr;
    return 0;
}

/* ================================================================== */
/* Reference-style bucketed heap minimum degree (exact-ordering parity
 * mode).  Replicates heap_minimum_degree_ordering (reference:
 * aprilsam.c:989-1249): degree buckets in a key->FIFO-queue map driven
 * by a heap of keys (smallest key first); the NEWEST node is keyed
 * nneighbors + 2*(n-1) so it eliminates last; nodes within +-5 ids of
 * the newest node's neighbors get the +rowi recency bias (key =
 * nneighbors + n-1), including the reference's inner loop that biases
 * nodes 0..deg-1 by LOOP INDEX (a faithful reproduction of the
 * published code's indexing, aprilsam.c:1080-1093); elimination
 * marginalizes the node (neighbors pairwise connected, set-token dedup,
 * shuffle-delete) and stale-degree nodes are re-queued at their current
 * degree.  The published code destroys popped queues while the hash
 * still references them (use-after-free) — this implementation keeps
 * one persistent FIFO per key, which is the defined behavior closest to
 * the code's intent; orderings therefore match the reference's CHOICES,
 * not its heap-allocator accidents. */

typedef struct { int32_t node; int32_t next; } qent_t;

int asn_order_heapmd(int32_t n, const int32_t *adj_ptr,
                     const int32_t *adj_idx, int32_t *order_out)
{
    if (n <= 0) return 0;
    if (n == 1) { order_out[0] = 0; return 0; }

    /* neighbor lists (self excluded), shuffle-delete semantics */
    int32_t *ncnt = (int32_t *)malloc(sizeof(int32_t) * n);
    int32_t *ncap = (int32_t *)malloc(sizeof(int32_t) * n);
    int32_t **nbr = (int32_t **)malloc(sizeof(int32_t *) * n);
    for (int i = 0; i < n; i++) {
        int deg = adj_ptr[i + 1] - adj_ptr[i];
        ncap[i] = deg * 2 + 8;
        nbr[i] = (int32_t *)malloc(sizeof(int32_t) * ncap[i]);
        ncnt[i] = 0;
        for (int k = adj_ptr[i]; k < adj_ptr[i + 1]; k++)
            if (adj_idx[k] != i) nbr[i][ncnt[i]++] = adj_idx[k];
    }

    /* key -> persistent FIFO queue (linked entries in a growable pool) */
    int64_t maxkey = 3LL * n + 8;
    int32_t *qhead = (int32_t *)malloc(sizeof(int32_t) * maxkey);
    int32_t *qtail = (int32_t *)malloc(sizeof(int32_t) * maxkey);
    uint8_t *inheap = (uint8_t *)calloc(maxkey, 1);
    for (int64_t k = 0; k < maxkey; k++) { qhead[k] = -1; qtail[k] = -1; }
    int pool_cap = 4 * n + 64, pool_n = 0;
    qent_t *pool = (qent_t *)malloc(sizeof(qent_t) * pool_cap);

    /* min-heap of keys */
    int64_t *hk = (int64_t *)malloc(sizeof(int64_t) * (2 * maxkey + 8));
    int hn = 0;

#define HPUSH(K) do { \
        int64_t _hk2 = (K); int _i = hn++; hk[_i] = _hk2; \
        while (_i > 0 && hk[(_i - 1) / 2] > hk[_i]) { \
            int64_t _t = hk[(_i - 1) / 2]; hk[(_i - 1) / 2] = hk[_i]; \
            hk[_i] = _t; _i = (_i - 1) / 2; } \
    } while (0)

#define QADD(K, NODE) do { \
        int64_t _k = (K); \
        if (pool_n >= pool_cap) { \
            pool_cap *= 2; \
            pool = (qent_t *)realloc(pool, sizeof(qent_t) * pool_cap); } \
        int _e = pool_n++; \
        pool[_e].node = (NODE); pool[_e].next = -1; \
        if (qtail[_k] >= 0) pool[qtail[_k]].next = _e; else qhead[_k] = _e; \
        qtail[_k] = _e; \
        if (!inheap[_k]) { inheap[_k] = 1; HPUSH(_k); } \
    } while (0)

    uint8_t *set_marker = (uint8_t *)calloc(n, 1);

    /* newest node: key = deg + 2*rowi (aprilsam.c:1023-1037) */
    {
        int rowi = n - 1;
        QADD((int64_t)ncnt[rowi] + 2 * rowi, rowi);
        set_marker[rowi] = 1;
        for (int i = 0; i < ncnt[rowi]; i++) {
            int32_t ch = nbr[rowi][i];
            for (int idx = ch - 5; idx < ch + 5; idx++) {
                if (idx < 0 || idx > n - 1) continue;
                if (set_marker[idx]) continue;
                QADD((int64_t)ncnt[idx] + rowi, idx);
                set_marker[idx] = 1;
                /* the published inner loop biases nodes 0..deg(idx)-1 by
                 * LOOP INDEX (aprilsam.c:1080-1093) — reproduced as-is */
                for (int j = 0; j < ncnt[idx]; j++) {
                    if (j < n && set_marker[j]) continue;
                    if (j >= n) continue;
                    QADD((int64_t)ncnt[j] + rowi, j);
                }
            }
        }
    }
    for (int rowi = 0; rowi < n - 1; rowi++) {
        if (set_marker[rowi]) continue;
        QADD((int64_t)ncnt[rowi], rowi);
    }
    free(set_marker);

    uint8_t *eliminated = (uint8_t *)calloc(n, 1);
    int32_t *set = (int32_t *)calloc(n, sizeof(int32_t));
    int32_t settoken = 0;
    int k_out = 0;

    while (hn > 0) {
        int64_t key = hk[0];
        /* pop root */
        hk[0] = hk[--hn];
        {
            int i = 0;
            for (;;) {
                int l = 2 * i + 1, r = l + 1, m = i;
                if (l < hn && hk[l] < hk[m]) m = l;
                if (r < hn && hk[r] < hk[m]) m = r;
                if (m == i) break;
                int64_t t = hk[i]; hk[i] = hk[m]; hk[m] = t;
            }
        }
        inheap[key] = 0;
        int32_t e = qhead[key];
        qhead[key] = -1; qtail[key] = -1;
        while (e >= 0) {
            int32_t node = pool[e].node;
            e = pool[e].next;
            if (eliminated[node]) continue;
            if ((int64_t)ncnt[node] <= key) {
                order_out[k_out++] = node;
                eliminated[node] = 1;
                /* marginalize (aprilsam.c:1147-1200) */
                for (int ai = 0; ai < ncnt[node]; ai++) {
                    int32_t na = nbr[node][ai];
                    settoken++;
                    for (int i = 0; i < ncnt[na]; i++) {
                        if (nbr[na][i] == node) {
                            nbr[na][i] = nbr[na][ncnt[na] - 1];
                            ncnt[na]--;
                            i--;
                            continue;
                        }
                        set[nbr[na][i]] = settoken;
                    }
                    set[node] = settoken;
                    set[na] = settoken;
                    for (int bi = 0; bi < ncnt[node]; bi++) {
                        int32_t nb = nbr[node][bi];
                        if (set[nb] == settoken) continue;
                        if (ncnt[na] + 1 >= ncap[na]) {
                            ncap[na] *= 2;
                            nbr[na] = (int32_t *)realloc(
                                nbr[na], sizeof(int32_t) * ncap[na]);
                        }
                        nbr[na][ncnt[na]++] = nb;
                    }
                }
            } else {
                /* stale degree: re-queue at the current degree
                 * (aprilsam.c:1226-1239) */
                QADD((int64_t)ncnt[node], node);
            }
        }
    }
    /* any node never popped (unreachable in practice) appends in id order */
    for (int i = 0; i < n; i++)
        if (!eliminated[i]) order_out[k_out++] = i;

#undef QADD
#undef HPUSH
    for (int i = 0; i < n; i++) free(nbr[i]);
    free(nbr); free(ncnt); free(ncap);
    free(qhead); free(qtail); free(inheap); free(pool); free(hk);
    free(eliminated); free(set);
    return (k_out == n) ? 0 : -1;
}
