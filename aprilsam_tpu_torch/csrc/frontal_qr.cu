// The frontal QR update of one incremental step, for Hopper: the triangle
// R of the affected rows and the step's square-root measurement rows A are
// refactored as [R; A] = Q [R'; 0], with y' = Q^T [y; rhs] alongside, in
// the form of LAPACK's tpqrt (a triangle on top of dense rows) and with
// R's diagonal made positive.  This is the factor update of the
// reference's aprilsam.c:850-906.
//
// Replaces no TPU kernel: the JAX package leaves this QR to XLA
// (aprilsam_tpu/solver/incremental.py:806).  It was added because
// cuSOLVER's dense QR of the padded frontal matrix [R_dense; W^1/2 J]
// (torch.linalg.qr, then Q^T d) took 3.24 s of the 7.07 s of device time
// of an M3500 per-step pass on an H100, 46 %: cuSOLVER factors every
// padded row and column, while the live problem is a triangle of 3m
// columns under p_live <= 12 measurement rows (m live front slots of M,
// at most four factors a step).
//
// What bounds it.  The work is small: 2 p_live (3m)^2 flops, 3.4 MFLOP at
// m = 126, p_live = 9, which the FP64 units of one SM do in about 16 us.
// Bytes are smaller still (the live triangle of R read and written once).
// What bounds it is the chain of 3m reflectors: reflector k needs column k
// as every earlier reflector left it, so each link costs a norm, a
// reciprocal square root, a reciprocal, a hand-over to every column and a
// dot product, one after the other.
//
// Design: keep every link short, and do no work on what is not live.
//   * One thread per column of A (two per thread above 256 columns).  A
//     thread holds its column's live measurement rows in registers for the
//     whole sweep, so A is read once and never written; reflector k
//     touches only row k of R (the triangle's other rows are not in its
//     support), so a thread streams its column of R from device memory,
//     four rows ahead of the sweep, and writes each entry once, final.
//     The right-hand side is one more column: y with the rows' rhs.
//   * Reflector k: the owner of column k forms it from R[k][k] and its
//     registers (H = I - g u u^T, u = (alpha - beta, x), beta =
//     -sign(alpha) |(alpha, x)|, g = 1 / (beta (beta - alpha)): a
//     reciprocal square root and a reciprocal, each the hardware's
//     approximation and two Newton steps) and publishes u and g in shared
//     memory (two buffers, alternating); one barrier; every later column
//     reads them and applies H to itself: a dot product of p_live + 1
//     terms and p_live + 1 multiply-adds, with no branch (a warp whose
//     columns are all done skips the step).  One barrier per column; no
//     other synchronisation.  The diagonal comes out positive: a negative
//     beta negates row k as the reference's sign flip does, and a column
//     whose A part is zero gets the identity, negated where its diagonal
//     is negative.
//   * The live counts are read on the device (ctl[0] slots, ctl[1] xyt and
//     ctl[2] position factors), so one captured graph serves every step of
//     its signature and the sweep covers the 3 ctl[0] live columns and the
//     3 (ctl[1] + ctl[2]) live rows only: dead slots (identity in R, zero
//     in A) are left as they are, and the columns before the first one
//     where A is nonzero get the identity (their rows are only negated
//     where the diagonal is negative).
//   * More than kRows live rows are taken kRows at a time: each group is
//     one more sweep over the triangle the previous one left (a QR update
//     by the rows in turn is the QR update by all of them).  At a
//     superstep's few hundred live rows that is tens of sweeps, slower
//     than cuSOLVER's blocked QR (PERF.md section 6), so the solver keeps
//     cuSOLVER for those signatures.
//   * Above 1024 columns (M = 1024: up to 3072 live columns) the columns
//     are spread over a cluster of up to 8 blocks; the barrier is the
//     cluster's, and the owner writes the reflector into every block's
//     shared memory (distributed shared memory) before it.
// Measured on an H100 (PERF.md section 6), a step costs about 0.5 us a
// column at M = 256: the owner's chain (norm, reciprocal square root,
// reciprocal) and the dot product each wait on the one before, and the
// later columns' multiply-adds share the SM's FP64 pipes with that chain.
// Not taken, both measured: a panel of 32 columns factored by one warp
// with shuffles, the other warps applying its reflectors after one barrier
// a panel: 1.4x slower at M = 256 (the panel's chain and its own updates
// sit in one warp), 1.4x faster in a cluster at M = 1024 (a cluster
// barrier a panel instead of a column), where steps are rare; compact-WY
// panels (W = T^T (R_rows + V^T A)) keep the same chain of links and add
// nb^2 / 2 multiply-adds a column a panel.
//
// Shared memory: two published reflectors and two counters, 256 bytes; no
// dynamic shared memory, so no function attribute is set (clusters of at
// most 8 blocks are the portable size).  Registers: nvcc -Xptxas -v, in
// the build's log; chip_smoke.py prints them.
//
// Interface: plain C entry points (no PyTorch headers), loaded with ctypes
// by aprilsam_tpu_torch/kernels/frontal_qr.py.  Each updates R and y in
// place, reads A, rhs and ctl, launches one kernel on the given stream,
// does not synchronise, and returns the first cudaGetLastError() that is
// not cudaSuccess.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 12;     // measurement rows a sweep holds in registers
constexpr int kAhead = 4;     // rows of R in flight ahead of the sweep
constexpr int kPub = kRows + 3;   // u0, g, the sign, then x
constexpr int kMaxCluster = 8;

// Threads of a block: columns per thread 1 up to 256 columns, else 2.
template <int CPT>
constexpr int max_threads() {
    return CPT == 1 ? 256 : 512;
}

template <bool kCluster>
__device__ __forceinline__ void barrier() {
    if constexpr (kCluster) {
        cg::this_cluster().sync();
    } else {
        __syncthreads();
    }
}

// 1 / x and 1 / sqrt(x) from the hardware's approximations and two Newton
// steps each (within an ulp or two; the IEEE-rounded division and square
// root cost more on the chain).
__device__ __forceinline__ double rcp_nr(double x) {
    double r;
    asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(x));
    double e = fma(-x, r, 1.0);
    r = fma(r, e, r);
    e = fma(-x, r, 1.0);
    return fma(r, e, r);
}
__device__ __forceinline__ double rsqrt_nr(double x) {
    double r;
    asm("rsqrt.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(x));
    const double h = 0.5 * x;
    double t = fma(-h * r, r, 0.5);
    r = fma(r, t, r);
    t = fma(-h * r, r, 0.5);
    return fma(r, t, r);
}
__device__ __forceinline__ float rcp_nr(float x) { return __frcp_rn(x); }
__device__ __forceinline__ float rsqrt_nr(float x) { return rsqrtf(x); }

// Entry (k, j) of the augmented triangle [R | y]: R[k][j] for a column j <
// nl, y[k] for the right-hand side j == nl.  The address is clamped (row j
// of column j, row nl - 1 of y; threads past the right-hand side read y),
// so every thread loads without a branch on the loaded value: a thread
// uses it only where k <= j.
template <typename T>
__device__ __forceinline__ T fetch(const T* r, const T* y, int n, int nl,
                                   int k, int j) {
    const T* p = j < nl ? r + static_cast<size_t>(k < j ? k : j) * n + j
                        : y + (k < nl ? k : nl - 1);
    return *p;
}

// r [n, n] and y [n]: the frontal triangle in slot order (identity on dead
// slots) and its right-hand side, updated in place.  a [6 kcap, n]: the
// xyt factors' rows (3 kcap), then the position factors' (3 kcap), live
// ones first in each; rhs [6 kcap].  ctl: the step's counts (ctl[0] live
// slots, ctl[1] xyt factors, ctl[2] position factors).  Block b of the
// grid (its rank in the cluster) owns columns b * CPT * blockDim.x + t +
// c * blockDim.x, c < CPT: a warp's columns are consecutive.
template <typename T, int CPT, bool kCluster>
__global__ void __launch_bounds__(max_threads<CPT>())
frontal_qr_kernel(T* __restrict__ r, T* __restrict__ y,
                  const T* __restrict__ a, const T* __restrict__ rhs,
                  const long long* __restrict__ ctl, int n, int kcap) {
    __shared__ T pub[2][kPub];        // reflector k, by the parity of k
    __shared__ int first_nz[2];

    const int tpb = blockDim.x;
    const int span = CPT * tpb;
    const int lane = threadIdx.x & 31;
    int rank = 0, nblocks = 1;
    if constexpr (kCluster) {
        rank = static_cast<int>(cg::this_cluster().block_rank());
        nblocks = static_cast<int>(cg::this_cluster().num_blocks());
    }
    int col[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) col[c] = rank * span + c * tpb + threadIdx.x;

    const long long m = ctl[0], fx = ctl[1], fp = ctl[2];
    const int nl = 3 * static_cast<int>(m < 0 ? 0 : (m > n / 3 ? n / 3 : m));
    const int kx = static_cast<int>(fx < 0 ? 0 : (fx > kcap ? kcap : fx));
    const int kp = static_cast<int>(fp < 0 ? 0 : (fp > kcap ? kcap : fp));
    const int pl = 3 * (kx + kp);
    if (threadIdx.x < 2) first_nz[threadIdx.x] = INT_MAX;
    barrier<kCluster>();   // in a cluster: every block running, counters set
    if (nl == 0) return;

    // Each column's entries R[k][j] (y[k] for the right-hand side) at
    // base[c] + k * step[c]; a thread past the right-hand side reads y and
    // stores nothing.  The last column of this warp that the sweep updates
    // (-1: none) lets a warp that is done skip the step's arithmetic.
    T* base[CPT];
    int step[CPT];
    int warp_last = -1;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
        const int j = col[c];
        base[c] = j < nl ? r + j : y;
        step[c] = j < nl ? n : 1;
        const int w0 = j - lane;              // the warp's first column here
        const int wl = w0 + 31 < nl ? w0 + 31 : nl;
        if (w0 <= nl && wl > warp_last) warp_last = wl;
    }

    const int groups = pl > 0 ? (pl + kRows - 1) / kRows : 1;
    for (int grp = 0; grp < groups; ++grp) {
        // this group's rows of each own column, zero past the live rows
        T av[CPT][kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
            const int q = grp * kRows + i;
            const int row = q < 3 * kx ? q : 3 * kcap + q - 3 * kx;
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
                const int j = col[c];
                T v = T(0);
                if (q < pl) {
                    if (j < nl) v = a[static_cast<size_t>(row) * n + j];
                    else if (j == nl) v = rhs[row];
                }
                av[c][i] = v;
            }
        }

        // the first column where these rows are nonzero
        int mine = INT_MAX;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
            bool nz = false;
#pragma unroll
            for (int i = 0; i < kRows; ++i) nz |= av[c][i] != T(0);
            if (nz && col[c] < nl && col[c] < mine) mine = col[c];
        }
        mine = __reduce_min_sync(0xffffffffu, mine);
        if (lane == 0 && mine != INT_MAX) atomicMin(&first_nz[grp & 1], mine);
        barrier<kCluster>();
        int kf = first_nz[grp & 1];
        if constexpr (kCluster) {
            for (int q = 0; q < nblocks; ++q) {
                const int v = *cg::this_cluster().map_shared_rank(
                    &first_nz[grp & 1], q);
                kf = v < kf ? v : kf;
            }
        }
        if (kf > nl) kf = nl;
        // the next group's counter: last read in the group before this one,
        // and at least one barrier comes before the next group's atomicMin
        if (threadIdx.x == 0) first_nz[(grp + 1) & 1] = INT_MAX;

        // columns before kf: identity reflectors, a row negated where its
        // diagonal is negative (every diagonal read before any is negated)
        if (kf > 0) {
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
                const int j = col[c];
                if (j > nl) continue;
                const int lim = j < kf ? j : kf;
                for (int k = 0; k < lim; ++k) {
                    if (r[static_cast<size_t>(k) * n + k] < T(0)) {
                        if (j < nl) {
                            T* e = r + static_cast<size_t>(k) * n + j;
                            *e = -*e;
                        } else {
                            y[k] = -y[k];
                        }
                    }
                }
            }
            barrier<kCluster>();
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
                const int j = col[c];
                if (j < kf) {
                    T* e = r + static_cast<size_t>(j) * n + j;
                    if (*e < T(0)) *e = -*e;
                }
            }
        }

        // the sweep over columns kf .. nl - 1.  rq[c][d] holds column c's
        // entry of the next row k with k % kAhead == d, loaded kAhead rows
        // ahead (a column's rows below its diagonal are read, not used).
        T rq[CPT][kAhead];
#pragma unroll
        for (int d = 0; d < kAhead; ++d) {
            const int kd = kf + ((d - kf) & (kAhead - 1));
#pragma unroll
            for (int c = 0; c < CPT; ++c)
                rq[c][d] = kd < nl ? base[c][static_cast<size_t>(kd) * step[c]]
                                   : T(0);
        }
        for (int k0 = kf & ~(kAhead - 1); k0 < nl; k0 += kAhead) {
#pragma unroll
            for (int d = 0; d < kAhead; ++d) {
                const int k = k0 + d;
                if (k < kf) continue;              // the same k everywhere
                if (k >= nl) break;
                T* pb = pub[k & 1];
#pragma unroll
                for (int c = 0; c < CPT; ++c) {
                    if (col[c] != k) continue;
                    // the owner: reflector k from (R[k][k], its rows), H =
                    // I - g u u^T, u = (u0, x), u0 = alpha - beta, beta =
                    // -sign(alpha) |(alpha, x)|, g = 1 / (beta (beta -
                    // alpha)); sg negates row k where beta < 0, so that the
                    // diagonal comes out positive; a zero x gives the
                    // identity, negated where alpha < 0
                    const T alpha = rq[c][d];
                    T s0 = T(0), s1 = T(0), s2 = T(0);
#pragma unroll
                    for (int i = 0; i < kRows; i += 3) {
                        s0 += av[c][i] * av[c][i];
                        s1 += av[c][i + 1] * av[c][i + 1];
                        s2 += av[c][i + 2] * av[c][i + 2];
                    }
                    const T s = s0 + s1 + s2;
                    const bool id = s == T(0);
                    const T q = alpha * alpha + s;
                    const T nrm = q * rsqrt_nr(id ? T(1) : q);
                    const T beta = alpha >= T(0) ? -nrm : nrm;
                    const T u0 = id ? T(0) : alpha - beta;
                    const T g = id ? T(0) : -rcp_nr(beta * (alpha - beta));
                    const T sg = (id ? alpha : beta) < T(0) ? T(-1) : T(1);
                    T vals[kPub];
                    vals[0] = u0;
                    vals[1] = g;
                    vals[2] = sg;
#pragma unroll
                    for (int i = 0; i < kRows; ++i) vals[3 + i] = av[c][i];
                    if constexpr (kCluster) {
                        // into every block's shared memory: the barrier's
                        // release makes it visible there
                        for (int b = 0; b < nblocks; ++b) {
                            T* dst = cg::this_cluster().map_shared_rank(pb, b);
#pragma unroll
                            for (int i = 0; i < kPub; ++i) dst[i] = vals[i];
                        }
                    } else {
#pragma unroll
                        for (int i = 0; i < kPub; ++i) pb[i] = vals[i];
                    }
                    base[c][static_cast<size_t>(k) * step[c]] =
                        id ? sg * alpha : nrm;
                }
                barrier<kCluster>();
                if (warp_last <= k) continue;      // this warp is done
                const T u0 = pb[0], g = pb[1], sg = pb[2];
                T x[kRows];
#pragma unroll
                for (int i = 0; i < kRows; ++i) x[i] = pb[3 + i];
                const bool ahead = k + kAhead < nl;
#pragma unroll
                for (int c = 0; c < CPT; ++c) {
                    T w0 = u0 * rq[c][d], w1 = T(0), w2 = T(0);
#pragma unroll
                    for (int i = 0; i < kRows; i += 3) {
                        w0 += x[i] * av[c][i];
                        w1 += x[i + 1] * av[c][i + 1];
                        w2 += x[i + 2] * av[c][i + 2];
                    }
                    const T gw = g * (w0 + w1 + w2);
                    const T out = sg * (rq[c][d] - gw * u0);
#pragma unroll
                    for (int i = 0; i < kRows; ++i) av[c][i] -= gw * x[i];
                    T* row = base[c] + static_cast<size_t>(k) * step[c];
                    if (col[c] > k && col[c] <= nl) *row = out;
                    if (ahead) rq[c][d] = row[kAhead * step[c]];
                }
            }
        }
    }
    // a block's shared memory stays until every block of the cluster is
    // done writing to it
    if constexpr (kCluster) barrier<true>();
}

template <typename T, int CPT, bool kCluster>
cudaError_t launch_one(T* r, T* y, const T* a, const T* rhs,
                       const long long* ctl, int n, int kcap, int threads,
                       int blocks, cudaStream_t stream) {
    if constexpr (kCluster) {
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3(blocks, 1, 1);
        cfg.blockDim = dim3(threads, 1, 1);
        cfg.dynamicSmemBytes = 0;
        cfg.stream = stream;
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = blocks;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
        cudaError_t err = cudaLaunchKernelEx(
            &cfg, frontal_qr_kernel<T, CPT, true>, r, y, a, rhs, ctl, n,
            kcap);
        if (err != cudaSuccess) return err;
    } else {
        frontal_qr_kernel<T, CPT, false>
            <<<blocks, threads, 0, stream>>>(r, y, a, rhs, ctl, n, kcap);
    }
    return cudaGetLastError();
}

// The layout follows the signature's shape alone (n = 3M columns and the
// right-hand side): one column a thread up to 256 columns, two up to 1024,
// then a cluster of blocks of 1024 columns each.
template <typename T>
int launch(T* r, T* y, const T* a, const T* rhs, const long long* ctl, int n,
           int kcap, void* stream) {
    if (n <= 0 || n % 3 != 0 || kcap < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int cols = n + 1;
    auto round32 = [](int v) { return (v + 31) / 32 * 32; };
    if (cols <= max_threads<1>())
        return static_cast<int>(launch_one<T, 1, false>(
            r, y, a, rhs, ctl, n, kcap, round32(cols), 1, s));
    const int per_block = 2 * max_threads<2>();
    if (cols <= per_block)
        return static_cast<int>(launch_one<T, 2, false>(
            r, y, a, rhs, ctl, n, kcap, round32((cols + 1) / 2), 1, s));
    const int blocks = (cols + per_block - 1) / per_block;
    if (blocks > kMaxCluster) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_one<T, 2, true>(
        r, y, a, rhs, ctl, n, kcap, max_threads<2>(), blocks, s));
}

}  // namespace

extern "C" int aprilsam_frontal_qr_f64(double* r, double* y, const double* a,
                                       const double* rhs,
                                       const long long* ctl, int n, int kcap,
                                       void* stream) {
    return launch<double>(r, y, a, rhs, ctl, n, kcap, stream);
}

extern "C" int aprilsam_frontal_qr_f32(float* r, float* y, const float* a,
                                       const float* rhs, const long long* ctl,
                                       int n, int kcap, void* stream) {
    return launch<float>(r, y, a, rhs, ctl, n, kcap, stream);
}
