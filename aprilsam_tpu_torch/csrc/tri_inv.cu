// Batched inverse of upper-triangular matrices, X[b] = T[b]^-1, for Hopper.
//
// Replaces the TPU kernel aprilsam_tpu/kernels/pallas_tri.py:tri_inv_pallas
// (:96; body _tri_inv_kernel, diagonal-tile helper _invert_diag_tile).  The
// full-path sweep (kernels/sweep.py:panel_backsub) inverts every panel
// diagonal triangle once per full step: T [B, N, N] with N = 3 * panel_nodes
// = 384 at the default configuration and B = NPANB, a power of two from 1 to
// 32 that grows with the graph.
//
// What bounds it.  At [32, 384, 384] float64 the function must read the
// upper triangle of T once and write all of X once: 56.7 MB, 16.9 us at the
// H100 SXM's 3.35 TB/s, against N^3/3 flops per matrix (0.61 GFLOP, 9 us at
// the 67 TFLOP/s FP64 tensor-core peak): bytes bound it at B = 32.  At
// B <= 4 the bytes take under 2.2 us, and the time is the serial chain of
// tile steps in one column of the matrix plus the two launches.
// (chip_smoke.py recomputes the bound for the card it runs on.)
//
// Design: the Pallas kernel's blocked algorithm with 48-wide diagonal tiles,
// laid out over the SMs in two launches.  The matrix is taken as padded to
// nt = ceil(N / 48) tiles with the identity, by masked loads (no padding
// pass); X is the only workspace, nothing is allocated.
//   1. diag_kernel: one block per (matrix, diagonal tile I) inverts the
//      tile into X by back-substitution, thread j owning column j in
//      registers (FMAs on the CUDA cores, no barrier inside the solve); one
//      block per tile below the diagonal writes its zeros.
//   2. strip_kernel: one block per (matrix, strip of W columns of tile J >=
//      1), longest strips (J descending) first.  The strip's rows of X stay
//      in shared memory; for I = J-1 down to 0 it forms
//      R = -sum_{K=J..I+1} T_IK X_K and X_I = D_I^-1 R, 48 x 48 by 48 x W
//      tile products whose 48 x 48 operands ("chunks": T_IK, then D_I^-1
//      read back from X) stream through a ring of up to 8 cp.async slots.
//      Float64 products run on the FP64 tensor cores: mma.sync m16n8k8 f64
//      (DMMA; wgmma has no f64 form), warps = three 16-row groups x two
//      halves of k, x two column halves at W = 48 (twelve warps, three per
//      scheduler).  Float32 runs the same tiling with FP32 FMAs on the CUDA
//      cores, never TF32.  Strips are independent, so no block waits on
//      another; the serial chain is at most nt - 1 steps, not N rows.
//   W = 48 when B (nt - 1) full-width strips fill the SMs (B = 32 at
//   N = 384; float64 only), else 16 (B = 16) or 8 (B <= 8): more blocks at
//   small B for more reads of T from L2.  The ring is as deep as fits,
//   unless two blocks can share an SM and there are over 1.5 blocks per SM.
//   Where the strip's nt * 48 rows do not fit in shared memory (N above
//   1968 in float64, 4416 in float32, on an H100), the strip's rows stream
//   (W = 8): each X_K is read back from X through the ring after T_IK, and
//   shared memory holds one tile of rows and up to 5 slots, whatever N.
//   Not taken: the level-recursive form (X12 = -A^-1 T12 C^-1 at s = 48,
//   96, 192), which needs about seven launches, whose latency alone is the
//   B <= 4 time; and row copies by bulk copy (cp.async.bulk, one per 384-byte
//   row, an mbarrier per slot), which measured slower than cp.async here.
//
// Resources (nvcc -Xptxas -v, sm_90a; chip_smoke.py prints them from the
// build's log), registers / static shared memory / spill bytes stored:
//   diag_kernel<double> 128 / 20352 / 0     diag_kernel<float> 78 / 10176 / 0
//   strip_kernel<double, 48, false> 80 / 0 / 28
//   strip_kernel<double, 16, false> 78 / 0 / 0
//   strip_kernel<double, 8, false> 64 / 0 / 0
//   strip_kernel<double, 8, true> 64 / 0 / 24
//   strip_kernel<float, 16, false> 48 / 0 / 0
//   strip_kernel<float, 8, false> 39 / 0 / 0
//   strip_kernel<float, 8, true> 48 / 0 / 0
// plus the strip kernels' dynamic shared memory: nt * 48 * (W + 4) entries
// for the strip's rows (48 * (W + 4) when they stream) and 48 * 52 for each
// ring slot (219648 bytes at [32, 384, 384] float64, W = 48, three slots).
//
// Interface: plain C entry points (no PyTorch headers), loaded with ctypes
// by aprilsam_tpu_torch/kernels/tri_inv.py.  Each launches both kernels on
// the given stream, does not synchronise, and returns the first
// cudaGetLastError() that is not cudaSuccess.

#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kTile = 48;                // diagonal tile (BLK of pallas_tri.py)
constexpr int kTileStride = kTile + 4;   // smem row stride: no bank conflicts
constexpr int kMaxRing = 8;              // most ring slots
constexpr int kMaxStreamRing = 5;        // most when X's rows stream
constexpr int kDiagThreads = 128;

// Threads of a strip block: twelve warps for float64 at W = 48, else six
// (measured: twelve warps were slower at W = 16 and in float32).
template <typename T>
constexpr int strip_threads(int w) {
    return sizeof(T) == 8 && w == 48 ? 384 : 192;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
    if constexpr (BYTES == 16) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                     :: "r"(smem_addr(dst)), "l"(src) : "memory");
    } else if constexpr (BYTES == 8) {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                     :: "r"(smem_addr(dst)), "l"(src) : "memory");
    } else {
        static_assert(BYTES == 4, "cp.async copies 4, 8 or 16 bytes");
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                     :: "r"(smem_addr(dst)), "l"(src) : "memory");
    }
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

// Waits until at most `pending` (0 .. kMaxRing - 2) groups are in flight.
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
    switch (pending) {
        case 6: cp_async_wait<6>(); break;
        case 5: cp_async_wait<5>(); break;
        case 4: cp_async_wait<4>(); break;
        case 3: cp_async_wait<3>(); break;
        case 2: cp_async_wait<2>(); break;
        case 1: cp_async_wait<1>(); break;
        default: cp_async_wait<0>(); break;
    }
}

// Starts copying the [48 x COLS] tile of the n x n matrix src at (r0, c0)
// into dst (row stride ds).  Entries outside the matrix are the identity's.
// vec: rows of src are 16-byte aligned, so whole tiles go 16 bytes a copy.
template <typename T, int COLS>
__device__ __forceinline__ void load_tile(T* dst, int ds, const T* src, int n,
                                          int r0, int c0, bool vec) {
    constexpr int kVec = 16 / sizeof(T);
    if (vec && r0 + kTile <= n && c0 + COLS <= n) {
        constexpr int kPerRow = COLS / kVec;
        for (int e = threadIdx.x; e < kTile * kPerRow; e += blockDim.x) {
            const int r = e / kPerRow;
            const int v = (e - r * kPerRow) * kVec;
            cp_async<16>(dst + r * ds + v,
                         src + static_cast<size_t>(r0 + r) * n + c0 + v);
        }
    } else {
        for (int e = threadIdx.x; e < kTile * COLS; e += blockDim.x) {
            const int r = e / COLS;
            const int c = e - r * COLS;
            const int gr = r0 + r;
            const int gc = c0 + c;
            if (gr < n && gc < n)
                cp_async<static_cast<int>(sizeof(T))>(dst + r * ds + c,
                                    src + static_cast<size_t>(gr) * n + gc);
            else
                dst[r * ds + c] = gr == gc ? T(1) : T(0);
        }
    }
}

// The [48 x W] accumulator of a strip step, spread over the block's
// strip_threads<T>(W) threads; add_product adds A [48 x 48] * B [48 x W],
// both in shared memory.  With kHalves = 2 each thread sums half of the
// 48-deep products (half() says which), and the true value is the sum of
// the two halves' entries.
template <typename T, int W>
struct Acc;

// float64: warp w holds rows 16(w%3) .. +15 over k = 24((w/3)%2) .. +23 and
// the kCols columns from kCols(w/6) on (all W of them with six warps), as
// m16n8k8 accumulators (lane g*4+t: rows g and g+8, columns 2t and 2t+1 of
// each 16 x 8 tile; A: (g, t), (g+8, t), (g, t+4), (g+8, t+4); B: (t, g),
// (t+4, g): the PTX ISA's m16n8k8 layout).  Splitting k between two warps
// keeps the chain of dependent mma short; twelve warps, three to each of
// the SM's four schedulers, keep the tensor cores evenly loaded.
template <int W>
struct Acc<double, W> {
    static constexpr int kHalves = 2;
    static constexpr int kCols = strip_threads<double>(W) == 384 ? W / 2 : W;
    double v[kCols / 8][4];

    __device__ __forceinline__ int half() const {
        return ((threadIdx.x >> 5) / 3) & 1;
    }

    __device__ __forceinline__ void zero() {
#pragma unroll
        for (int c = 0; c < kCols / 8; ++c)
            v[c][0] = v[c][1] = v[c][2] = v[c][3] = 0.0;
    }

    __device__ __forceinline__ void add_product(const double* a, int sa,
                                                const double* b, int sb) {
        const int lane = threadIdx.x & 31;
        const int w = threadIdx.x >> 5;
        const int g = lane >> 2;
        const int t = lane & 3;
        const int k0 = 24 * half() + t;
        const double* ar = a + (16 * (w % 3) + g) * sa + k0;
        const double* bc = b + k0 * sb + kCols * (w / 6) + g;
#pragma unroll
        for (int k = 0; k < kTile / 2; k += 8) {
            const double a0 = ar[k];
            const double a1 = ar[8 * sa + k];
            const double a2 = ar[k + 4];
            const double a3 = ar[8 * sa + k + 4];
#pragma unroll
            for (int c = 0; c < kCols / 8; ++c) {
                const double b0 = bc[k * sb + 8 * c];
                const double b1 = bc[(k + 4) * sb + 8 * c];
                double d0, d1, d2, d3;
                asm volatile(
                    "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
                    "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
                    "{%10, %11, %12, %13};\n"
                    : "=d"(d0), "=d"(d1), "=d"(d2), "=d"(d3)
                    : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1),
                      "d"(v[c][0]), "d"(v[c][1]), "d"(v[c][2]),
                      "d"(v[c][3]));
                v[c][0] = d0;
                v[c][1] = d1;
                v[c][2] = d2;
                v[c][3] = d3;
            }
        }
    }

    template <typename F>
    __device__ __forceinline__ void each(F f) const {
        const int lane = threadIdx.x & 31;
        const int r = 16 * ((threadIdx.x >> 5) % 3) + (lane >> 2);
        const int c2 = kCols * ((threadIdx.x >> 5) / 6) + 2 * (lane & 3);
#pragma unroll
        for (int c = 0; c < kCols / 8; ++c) {
            f(r, 8 * c + c2, v[c][0]);
            f(r, 8 * c + c2 + 1, v[c][1]);
            f(r + 8, 8 * c + c2, v[c][2]);
            f(r + 8, 8 * c + c2 + 1, v[c][3]);
        }
    }
};

// float32: thread i holds the kRows rows i/8 + kStep * m, columns
// i%8 + 8j; FP32 FMAs on the CUDA cores (no TF32).
template <int W>
struct Acc<float, W> {
    static constexpr int kHalves = 1;
    static constexpr int kStep = strip_threads<float>(W) / 8;
    static constexpr int kRows = kTile / kStep;
    float v[kRows][W / 8];

    __device__ __forceinline__ int half() const { return 0; }

    __device__ __forceinline__ void zero() {
#pragma unroll
        for (int m = 0; m < kRows; ++m)
#pragma unroll
            for (int j = 0; j < W / 8; ++j) v[m][j] = 0.0f;
    }

    __device__ __forceinline__ void add_product(const float* a, int sa,
                                                const float* b, int sb) {
        const float* ar = a + (threadIdx.x >> 3) * sa;
        const float* bc = b + (threadIdx.x & 7);
#pragma unroll 4
        for (int k = 0; k < kTile; ++k) {
            float x[kRows];
#pragma unroll
            for (int m = 0; m < kRows; ++m) x[m] = ar[m * kStep * sa + k];
#pragma unroll
            for (int j = 0; j < W / 8; ++j) {
                const float y = bc[k * sb + 8 * j];
#pragma unroll
                for (int m = 0; m < kRows; ++m) v[m][j] = fmaf(x[m], y, v[m][j]);
            }
        }
    }

    template <typename F>
    __device__ __forceinline__ void each(F f) const {
        const int r = threadIdx.x >> 3;
        const int c = threadIdx.x & 7;
#pragma unroll
        for (int m = 0; m < kRows; ++m)
#pragma unroll
            for (int j = 0; j < W / 8; ++j) f(r + kStep * m, c + 8 * j, v[m][j]);
    }
};

// Phase 1.  Blocks [0, B nt): block (b, I) inverts the diagonal tile I of
// matrix b into X.  The B nt (nt - 1) / 2 blocks after them write one zero
// tile of X below the diagonal each.
template <typename T>
__global__ void __launch_bounds__(kDiagThreads)
diag_kernel(const T* __restrict__ tm, T* __restrict__ x, int n, int nt,
            int batch, int vec) {
    __shared__ __align__(16) T ts[kTile * kTileStride];
    __shared__ T rd[kTile];
    const int ndiag = batch * nt;
    if (static_cast<int>(blockIdx.x) >= ndiag) {
        const int nz = nt * (nt - 1) / 2;
        const int z = blockIdx.x - ndiag;
        const int b = z / nz;
        int K = z - b * nz;       // tile (I, K), K < I
        int I = 1;
        while (K >= I) K -= I++;
        T* xz = x + static_cast<size_t>(b) * n * n +
                static_cast<size_t>(I) * kTile * n + K * kTile;
        const int rows = min(kTile, n - I * kTile);
        for (int e = threadIdx.x; e < rows * kTile; e += blockDim.x) {
            const int r = e / kTile;
            xz[static_cast<size_t>(r) * n + e - r * kTile] = T(0);
        }
        return;
    }
    const int b = blockIdx.x / nt;
    const int r0 = (blockIdx.x - b * nt) * kTile;
    const size_t off = static_cast<size_t>(b) * n * n;
    T* xb = x + off;

    // the whole tile; the solve reads only its upper triangle
    load_tile<T, kTile>(ts, kTileStride, tm + off, n, r0, r0, vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (threadIdx.x < kTile)
        rd[threadIdx.x] = T(1) / ts[threadIdx.x * (kTileStride + 1)];
    __syncthreads();
    if (threadIdx.x >= kTile) return;

    const int j = threadIdx.x;
    T v[kTile];
#pragma unroll
    for (int r = 0; r < kTile; ++r) v[r] = r == j ? T(1) : T(0);
#pragma unroll
    for (int i = kTile - 1; i >= 0; --i) {
        const T xi = v[i] * rd[i];
        v[i] = xi;
#pragma unroll
        for (int r = 0; r < i; ++r) v[r] -= ts[r * kTileStride + i] * xi;
    }
    if (r0 + j < n) {
#pragma unroll
        for (int r = 0; r < kTile; ++r)
            if (r0 + r < n)
                xb[static_cast<size_t>(r0 + r) * n + r0 + j] =
                    r <= j ? v[r] : T(0);
    }
}

// A position in a strip's chunk stream.  Step i takes, for k = J down to
// i+1, T's tile (i, k), followed (kStream) by the strip's rows of X's tile
// k; then (i, i), which stands for D_i^-1; then step i-1.
template <bool kStream>
struct Cursor {
    int i, k;
    bool xk;   // the strip's rows of X's tile k, not T's tile (i, k)

    __device__ __forceinline__ void next(int J) {
        if (kStream && k > i && !xk) {
            xk = true;
            return;
        }
        xk = false;
        if (k == i) {
            --i;
            k = J;
        } else {
            --k;
        }
    }
};

// Phase 2: block (J, b, s) fills the columns c0 = 48J + sW .. c0+W-1 of
// matrix b above its diagonal tile.  Launched after diag_kernel.  The strip's
// rows of every tile stay in shared memory, or, with kStream, only the rows
// of the step at hand: X's tiles k > i then stream through the ring after
// T's, read back from X, so that shared memory does not grow with N.
template <typename T, int W, bool kStream>
__global__ void __launch_bounds__(strip_threads<T>(W))
strip_kernel(const T* __restrict__ tm, T* __restrict__ x, int n, int nt,
             int batch, int ring_depth, int vec) {
    constexpr int kSW = W + 4;            // row stride of the strip rows
    constexpr int kStrips = kTile / W;    // strips per tile column
    constexpr int kChunk = kTile * kTileStride;
    // chunks a product holds at once beyond the one taken last: a streamed
    // product takes two, so its ring runs one slot further behind
    constexpr int kLag = kStream ? 2 : 1;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* xs = reinterpret_cast<T*>(smem_raw);     // [nt or 1][48][kSW]
    T* ring = xs + static_cast<size_t>(kStream ? 1 : nt) * kTile * kSW;
                                                // [ring_depth][48][52]

    const int per_col = batch * kStrips;
    const int jr = blockIdx.x / per_col;
    const int J = nt - 1 - jr;
    const int rem = blockIdx.x - jr * per_col;
    const int b = rem / kStrips;
    const int c0 = J * kTile + (rem - b * kStrips) * W;
    if (c0 >= n) return;
    const size_t off = static_cast<size_t>(b) * n * n;
    const T* tb = tm + off;
    T* xb = x + off;

    // a chunk into a ring slot: T's tile (i, k); for k == i X's tile (i, i),
    // which holds D_i^-1; or the strip's rows of X's tile k
    auto fetch = [&](int slot, const Cursor<kStream>& c) {
        T* dst = ring + slot * kChunk;
        if (c.xk)
            load_tile<T, W>(dst, kSW, xb, n, c.k * kTile, c0, vec);
        else
            load_tile<T, kTile>(dst, kTileStride, c.k > c.i ? tb : xb, n,
                                c.i * kTile, c.k * kTile, vec);
    };

    const int nchunks = (kStream ? J * (J + 1) : J * (J + 1) / 2) + J;
    if (!kStream) {
        // the strip's rows of tile J: columns of D_J^-1, from diag_kernel
        load_tile<T, W>(xs + J * kTile * kSW, kSW, xb, n, J * kTile, c0, vec);
        cp_async_commit();
    }
    Cursor<kStream> cur{J - 1, J, false};
    for (int p = 0; p < ring_depth - kLag; ++p) {
        if (p < nchunks) {
            fetch(p, cur);
            cur.next(J);
        }
        cp_async_commit();
    }

    // take(): the next chunk of the stream, once it has landed.  refill():
    // the chunk ring_depth - kLag further on, into the slot of the chunk
    // kLag before the one taken last, which every thread has finished with
    // once past take()'s barrier; one refill per take.
    // A streamed X tile k is written by this block at the end of step k, so
    // its copy must start after the next take()'s barrier.  It is fetched
    // after the barrier of the chunk ring_depth - 2 before it, and step k - 1
    // takes it 2(J - k + 1) >= 4 chunks after D_k (k < J; X_J comes from
    // diag_kernel): hence ring_depth - 1 <= 4 (kMaxStreamRing).
    int q = 0;
    auto take = [&]() -> const T* {
        cp_async_wait_pending(ring_depth - 1 - kLag);
        __syncthreads();   // chunk q landed; chunk q-kLag's slot is free
        return ring + (q++ % ring_depth) * kChunk;
    };
    auto refill = [&]() {
        const int f = q + ring_depth - 1 - kLag;
        if (f < nchunks) {
            fetch(f % ring_depth, cur);
            cur.next(J);
        }
        cp_async_commit();
    };

    // The accumulator is zeroed at the top of each step.  A single loop over
    // all chunks that zeroed it under a condition lost the accumulator's
    // rows g+8 between chunks (ptxas, CUDA 12.8): keep the loop by steps.
    Acc<T, W> acc;
    constexpr bool kSplit = Acc<T, W>::kHalves == 2;
    const bool first = acc.half() == 0;
    for (int i = J - 1; i >= 0; --i) {
        T* rows = kStream ? xs : xs + i * kTile * kSW;
        // R = -sum_k T_ik X_k, parked in the rows X_i will take
        acc.zero();
        for (int k = J; k > i; --k) {
            const T* tik = take();
            const T* xk;
            if constexpr (kStream) {
                refill();
                xk = take();
            } else {
                xk = xs + k * kTile * kSW;
            }
            acc.add_product(tik, kTileStride, xk, kSW);
            refill();
        }
        if (first)
            acc.each([&](int r, int c, T v) { rows[r * kSW + c] = -v; });
        if (kSplit) {
            __syncthreads();
            if (!first)
                acc.each([&](int r, int c, T v) { rows[r * kSW + c] -= v; });
        }
        // X_i = D_i^-1 R
        const T* dinv = take();
        acc.zero();
        acc.add_product(dinv, kTileStride, rows, kSW);
        refill();
        __syncthreads();   // every warp has read R
        T* xr = xb + static_cast<size_t>(i) * kTile * n + c0;
        auto put = [&](int r, int c, T v) {
            rows[r * kSW + c] = v;
            if (c0 + c < n) xr[static_cast<size_t>(r) * n + c] = v;
        };
        if (!kSplit) {
            acc.each(put);
        } else {
            if (first)
                acc.each([&](int r, int c, T v) { rows[r * kSW + c] = v; });
            __syncthreads();
            if (!first)
                acc.each([&](int r, int c, T v) {
                    put(r, c, rows[r * kSW + c] + v);
                });
        }
    }
}

// Shared memory of a strip block: its rows of all nt tiles, then the ring.
template <typename T, int W>
size_t strip_rows_smem(int nt) {
    return static_cast<size_t>(nt) * kTile * (W + 4) * sizeof(T);
}

template <typename T>
constexpr size_t chunk_smem() {
    return static_cast<size_t>(kTile) * kTileStride * sizeof(T);
}

constexpr int kMaxDevices = 64;

struct DeviceInfo {
    int optin;      // shared memory a block may opt in to
    int sms;
    int smem_sm;    // shared memory of one SM
    int reserved;   // shared memory the system keeps per block
};

// Queried, and the strip kernels' dynamic shared-memory limits raised to the
// opt-in, once per (type, device); then read from the cache.
template <typename T>
cudaError_t device_info(int dev, DeviceInfo* out) {
    static std::atomic<int> optin_cache[kMaxDevices];
    static DeviceInfo info[kMaxDevices];
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    int optin = optin_cache[dev].load(std::memory_order_acquire);
    if (optin == 0) {
        DeviceInfo d;
        cudaError_t err = cudaDeviceGetAttribute(
            &d.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&d.sms,
                                         cudaDevAttrMultiProcessorCount, dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(
                &d.smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(
                &d.reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
        optin = d.optin;
        const cudaFuncAttribute attr =
            cudaFuncAttributeMaxDynamicSharedMemorySize;
        if constexpr (sizeof(T) == 8)
            if (err == cudaSuccess)
                err = cudaFuncSetAttribute(strip_kernel<T, 48, false>, attr,
                                           optin);
        void (*kernels[])(const T*, T*, int, int, int, int, int) = {
            strip_kernel<T, 16, false>, strip_kernel<T, 8, false>,
            strip_kernel<T, 8, true>};
        for (auto kernel : kernels)
            if (err == cudaSuccess)
                err = cudaFuncSetAttribute(kernel, attr, optin);
        if (err != cudaSuccess) return err;
        info[dev] = d;
        optin_cache[dev].store(optin, std::memory_order_release);
    }
    *out = info[dev];
    return cudaSuccess;
}

// Whether a strip's rows of all nt tiles and a two-slot ring fit.
template <typename T, int W>
bool rows_fit(int nt, const DeviceInfo& d) {
    return strip_rows_smem<T, W>(nt) + 2 * chunk_smem<T>() <=
           static_cast<size_t>(d.optin);
}

// Ring depth: the deepest, from lo up to hi, that fits the opt-in; but when
// there are over 1.5 blocks per SM and two blocks could share an SM, the
// deepest that lets them (0: not even lo fit).
int pick_ring(size_t rows, size_t chunk, long long blocks, int lo, int hi,
              const DeviceInfo& d) {
    size_t budget = static_cast<size_t>(d.optin);
    const size_t half = static_cast<size_t>(d.smem_sm / 2 - d.reserved);
    if (2 * blocks > 3LL * d.sms && rows + lo * chunk <= half) budget = half;
    if (rows + lo * chunk > budget) return 0;
    const size_t ring = (budget - rows) / chunk;
    return ring < static_cast<size_t>(hi) ? static_cast<int>(ring) : hi;
}

template <typename T, int W, bool kStream>
cudaError_t launch_strips(const T* tm, T* x, int batch, int n, int nt,
                          bool vec, const DeviceInfo& d,
                          cudaStream_t stream) {
    const long long blocks =
        static_cast<long long>(nt - 1) * batch * (kTile / W);
    if (blocks > INT_MAX) return cudaErrorInvalidValue;
    const size_t rows = strip_rows_smem<T, W>(kStream ? 1 : nt);
    const int lo = kStream ? 3 : 2;
    const int ring = pick_ring(rows, chunk_smem<T>(), blocks, lo,
                               kStream ? kMaxStreamRing : kMaxRing, d);
    if (ring < lo) return cudaErrorInvalidValue;
    const size_t smem = rows + ring * chunk_smem<T>();
    strip_kernel<T, W, kStream>
        <<<static_cast<unsigned>(blocks), strip_threads<T>(W), smem,
           stream>>>(tm, x, n, nt, batch, ring, vec);
    return cudaGetLastError();
}

// Strip width: 48 when the B (nt - 1) full-width strips fill the SMs (in
// float64: in float32 16 measured faster there), else 16 when three times as
// many give 2 blocks per SM, else 8; always one whose rows of all tiles fit
// beside a two-slot ring.  When not even width 8's do, the strip's rows
// stream (width 8), and any N runs.
template <typename T>
cudaError_t dispatch_strips(const T* tm, T* x, int batch, int n, int nt,
                          bool vec, const DeviceInfo& d,
                          cudaStream_t stream) {
    const long long strips = static_cast<long long>(batch) * (nt - 1);
    if constexpr (sizeof(T) == 8)
        if (strips >= d.sms && rows_fit<T, 48>(nt, d))
            return launch_strips<T, 48, false>(tm, x, batch, n, nt, vec, d,
                                               stream);
    if (3 * strips >= 2LL * d.sms && rows_fit<T, 16>(nt, d))
        return launch_strips<T, 16, false>(tm, x, batch, n, nt, vec, d,
                                           stream);
    if (rows_fit<T, 8>(nt, d))
        return launch_strips<T, 8, false>(tm, x, batch, n, nt, vec, d,
                                          stream);
    return launch_strips<T, 8, true>(tm, x, batch, n, nt, vec, d, stream);
}

template <typename T>
int launch(const T* tm, T* x, int batch, int n, void* stream) {
    if (batch < 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
    if (batch == 0 || n == 0) return 0;
    const int nt = (n + kTile - 1) / kTile;
    // diagonal tiles, then the zero tiles below them
    const long long diag_blocks =
        static_cast<long long>(batch) * nt * (nt + 1) / 2;
    if (diag_blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    DeviceInfo d;
    err = device_info<T>(dev, &d);
    if (err != cudaSuccess) return static_cast<int>(err);

    // rows of T and X 16-byte aligned: whole rows go in one copy
    const bool vec = (static_cast<size_t>(n) * sizeof(T)) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(tm) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    diag_kernel<T><<<static_cast<unsigned>(diag_blocks), kDiagThreads, 0, s>>>(
        tm, x, n, nt, batch, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess || nt == 1) return static_cast<int>(err);
    return static_cast<int>(dispatch_strips<T>(tm, x, batch, n, nt, vec, d, s));
}

}  // namespace

extern "C" int aprilsam_tri_inv_f64(const double* tm, double* x, int batch,
                                    int n, void* stream) {
    return launch<double>(tm, x, batch, n, stream);
}

extern "C" int aprilsam_tri_inv_f32(const float* tm, float* x, int batch,
                                    int n, void* stream) {
    return launch<float>(tm, x, batch, n, stream);
}
