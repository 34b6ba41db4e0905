// Batched inverse of upper-triangular matrices, X[b] = T[b]^-1, for Hopper.
//
// Replaces the TPU kernel aprilsam_tpu/kernels/pallas_tri.py:tri_inv_pallas
// (body _tri_inv_kernel, diagonal-tile helper _invert_diag_tile).  The
// full-path sweep (kernels/sweep.py:panel_backsub) inverts every panel
// diagonal triangle once per full step: T [B, N, N] with B = NPANB <= 32 and
// N = 3 * panel_nodes = 384 at the default configuration.
//
// What bounds it.  At [32, 384, 384] float64 the kernel must read the upper
// triangle of T once (nothing below the diagonal is read) and write all of X
// once: 32 * (384 * 385 / 2 + 384 * 384) * 8 B = 56.7 MB, 16.9 us at the
// H100 SXM's 3.35 TB/s.  The arithmetic is N^3/3 flops per matrix, 0.61
// GFLOP in all: 9.0 us at the card's 67 TFLOP/s FP64 tensor-core peak, 18 us
// at its 34 TFLOP/s FP64 vector peak.  So the float64 work is bound by
// bytes, and an ideal kernel would stream each triangle through once; in
// float32 the same shape moves half the bytes and is bound by operations.
// (chip_smoke.py recomputes the bound for the card it runs on.)
//
// Design (simple first; making it fast is later work).  Row back-
// substitution, as the Pallas tile helper does inside each 48-wide tile, but
// over the whole matrix:
//     x[i, j] = (delta_ij - sum_{i<k<=j} T[i, k] x[k, j]) / T[i, i],
// rows i from the bottom up.  One block per (matrix, tile of CT columns):
// thread (c, r) owns column j = tile * CT + c and the r-th of RS interleaved
// slices of each dot product.  The column tile of X lives in shared memory
// ([N][CT], 96 KB at N = 384 in float64), T is read straight from global
// memory — all threads of a warp read the same T[i, k], which is one
// broadcast transaction — and each row ends with a shared-memory reduction
// over the RS slices.  Below the diagonal X is written as zero.  The block
// count is B * ceil(N / CT) = 384 at the default shape; the serial row loop
// (two barriers per row) and the triangular imbalance between column tiles,
// not the bytes, limit this version.  Blocked diagonal tiles with FP64 mma
// for the strips, as the Pallas kernel's tile walk does on the MXU, are the
// next step.
//
// Interface: plain C entry points (no PyTorch headers), loaded with ctypes
// by aprilsam_tpu_torch/kernels/tri_inv.py.  Each launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstddef>

namespace {

constexpr int kRowSplits = 8;   // RS: slices of each row's dot product
constexpr int kMaxCols = 32;    // CT: columns per block (one warp wide)

template <typename T>
__global__ void tri_inv_kernel(const T* __restrict__ tm, T* __restrict__ x,
                               int n, int ntiles, int ct) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* xs = reinterpret_cast<T*>(smem_raw);          // [n][ct] tile of X
    T* red = xs + static_cast<size_t>(n) * ct;       // [RS][ct] partials

    const int b = blockIdx.x / ntiles;
    const int tile = blockIdx.x - b * ntiles;
    const int c = threadIdx.x;
    const int r = threadIdx.y;
    const int j = tile * ct + c;
    const int jmax = min(n - 1, tile * ct + ct - 1);
    const T* tb = tm + static_cast<size_t>(b) * n * n;
    T* xb = x + static_cast<size_t>(b) * n * n;

    for (int i = jmax; i >= 0; --i) {
        const T* ti = tb + static_cast<size_t>(i) * n;
        T acc0 = T(0);
        T acc1 = T(0);
        int k = i + 1 + r;
        for (; k + kRowSplits <= jmax; k += 2 * kRowSplits) {
            acc0 += ti[k] * xs[k * ct + c];
            acc1 += ti[k + kRowSplits] * xs[(k + kRowSplits) * ct + c];
        }
        if (k <= jmax) acc0 += ti[k] * xs[k * ct + c];
        red[r * ct + c] = acc0 + acc1;
        __syncthreads();
        if (r == 0) {
            T s = T(0);
            for (int q = 0; q < kRowSplits; ++q) s += red[q * ct + c];
            T v = T(0);
            if (j <= jmax && i <= j) v = ((i == j ? T(1) : T(0)) - s) / ti[i];
            xs[i * ct + c] = v;
        }
        __syncthreads();
    }

    if (j < n) {
        for (int i = r; i < n; i += kRowSplits)
            xb[static_cast<size_t>(i) * n + j] = (i <= jmax) ? xs[i * ct + c]
                                                             : T(0);
    }
}

template <typename T>
size_t smem_bytes(int n, int ct) {
    return (static_cast<size_t>(n) * ct + kRowSplits * ct) * sizeof(T);
}

constexpr int kMaxDevices = 64;

// The device's opt-in shared memory per block, with the kernel's dynamic
// shared-memory limit raised to it: queried and set once per (type, device),
// then read from the cache.  0 means not yet done.
template <typename T>
cudaError_t shared_optin(int dev, int* out) {
    static std::atomic<int> cache[kMaxDevices];
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    int optin = cache[dev].load(std::memory_order_acquire);
    if (optin == 0) {
        cudaError_t err = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (err != cudaSuccess) return err;
        err = cudaFuncSetAttribute(tri_inv_kernel<T>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   optin);
        if (err != cudaSuccess) return err;
        cache[dev].store(optin, std::memory_order_release);
    }
    *out = optin;
    return cudaSuccess;
}

template <typename T>
int launch(const T* tm, T* x, int batch, int n, void* stream) {
    if (batch < 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
    if (batch == 0 || n == 0) return 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    int max_optin = 0;
    err = shared_optin<T>(dev, &max_optin);
    if (err != cudaSuccess) return static_cast<int>(err);

    int ct = kMaxCols;
    while (ct > 1 && smem_bytes<T>(n, ct) > static_cast<size_t>(max_optin))
        ct /= 2;
    const size_t smem = smem_bytes<T>(n, ct);
    if (smem > static_cast<size_t>(max_optin))
        return static_cast<int>(cudaErrorInvalidValue);

    const int ntiles = (n + ct - 1) / ct;
    const long long blocks = static_cast<long long>(batch) * ntiles;
    if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    tri_inv_kernel<T><<<static_cast<unsigned>(blocks), dim3(ct, kRowSplits),
                        smem, static_cast<cudaStream_t>(stream)>>>(
        tm, x, n, ntiles, ct);
    return static_cast<int>(cudaGetLastError());
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
