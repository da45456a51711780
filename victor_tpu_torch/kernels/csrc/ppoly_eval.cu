// Clamped piecewise-cubic evaluation for Hopper (sm_90a), K channels over one
// query set.
//
// Replaces victor_tpu/ops/splines.py::ppoly_eval_pallas, the Pallas TPU twin
// of ppoly_eval, together with the leading channel axes of that function's
// masksum (victor_tpu/ops/splines.py:245-262). It computes the same function,
// generalised to the batched shapes of the likelihood:
//
//   x      (n,)               knots, shared by every batch row, sorted
//   coeffs (Bc, K, n-1, 4)    ascending-power local coefficients, Bc in
//                             {1, B}, K in 1..4 channels sharing the knots
//   q      (B, M)             queries; out (B, K, M), each channel's plane
//                             contiguous
//
//   qq  = clamp ? clip(q, x[0], x[n-1]) : q        (NaN stays NaN)
//   i   = clip(searchsorted(x, qq, right) - 1, 0, n-2)
//   t   = qq - x[i]
//   out[k] = ((c3 t + c2) t + c1) t + c0 + (qq - qq),  c = coeffs[k, i]
//
// The `+ (qq - qq)` term is 0 for finite qq and NaN for a NaN query, so an
// invalid parameter point reaches the likelihood's NaN guard as NaN. The
// clamp is written with selects, not fmin/fmax: those return the non-NaN
// operand and would turn a NaN query into x[0].
//
// Layout: one thread per query. Each block serves one batch row: it stages
// the knots and that row's K coefficient tables (about 1 KB per channel at
// n = 31 in f64) in shared memory, then its threads stride over a slice of
// the row, find the interval once by binary search over the staged knots and
// evaluate Horner's rule K times, one per channel. K is a template argument,
// so each channel's arithmetic is the same instruction sequence whatever K
// is: channel k of a K-channel call equals a 1-channel call on table k bit for
// bit. Rows and slices share gridDim.x, so a batch larger than 65,535 rows
// needs no gridDim.y; offsets are 64-bit because B*K*M passes 2^31 for a
// batch of about 14k parameter points.
//
// Bound: bytes. Per point it reads q and writes K outputs ((1 + K) * 8 B in
// f64) against about 5 compares and 6K flops, so the kernel cannot beat the
// card's memory rate and makes no attempt to: nothing here is tuned.
// nvcc contracts c3*t + c2 into an FMA, so results differ from the plain
// PyTorch version (separately rounded multiply and add) by a few ulp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T, int K>
__global__ void ppoly_eval_kernel(const T* __restrict__ x,
                                  const T* __restrict__ coeffs,
                                  const T* __restrict__ q,
                                  T* __restrict__ out,
                                  int n, int64_t M, int64_t blocks_per_row,
                                  int per_row_coeffs, int clamp) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* sx = reinterpret_cast<T*>(smem_raw);
    T* sc = sx + n;
    const int table = (n - 1) * 4;           // one channel's coefficients

    const int64_t row = blockIdx.x / blocks_per_row;
    const int64_t slice = blockIdx.x - row * blocks_per_row;
    const T* crow = coeffs + (per_row_coeffs ? row * (int64_t)K * table : 0);

    for (int i = threadIdx.x; i < n; i += blockDim.x) sx[i] = x[i];
    for (int i = threadIdx.x; i < K * table; i += blockDim.x) sc[i] = crow[i];
    __syncthreads();

    const T x0 = sx[0];
    const T xn = sx[n - 1];
    const T* qrow = q + row * M;
    T* orow = out + row * (int64_t)K * M;
    const int64_t stride = blocks_per_row * (int64_t)blockDim.x;
    for (int64_t j = slice * (int64_t)blockDim.x + threadIdx.x; j < M;
         j += stride) {
        T qq = qrow[j];
        if (clamp) {
            qq = (qq < x0) ? x0 : qq;
            qq = (qq > xn) ? xn : qq;
        }
        // largest i in [0, n-2] with x[i] <= qq (i = 0 when none, or NaN)
        int lo = 0, hi = n - 2;
        while (lo < hi) {
            const int mid = (lo + hi + 1) >> 1;
            if (sx[mid] <= qq) lo = mid; else hi = mid - 1;
        }
        const T t = qq - sx[lo];
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const T* c = sc + k * table + 4 * lo;
            orow[k * M + j] = ((c[3] * t + c[2]) * t + c[1]) * t + c[0]
                              + (qq - qq);
        }
    }
}

template <typename T, int K>
int launch_k(const void* x, const void* coeffs, const void* q, void* out,
             int n, long long B, long long M, long long blocks_per_row,
             int per_row_coeffs, int clamp, void* stream) {
    const int threads = 256;
    const size_t smem = sizeof(T) * ((size_t)n + 4 * (size_t)K * (n - 1));
    const dim3 grid((unsigned int)(B * blocks_per_row));
    ppoly_eval_kernel<T, K><<<grid, threads, smem, (cudaStream_t)stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(coeffs),
        static_cast<const T*>(q), static_cast<T*>(out), n, (int64_t)M,
        (int64_t)blocks_per_row, per_row_coeffs, clamp);
    return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* coeffs, const void* q, void* out,
           int n, int K, long long B, long long M, long long blocks_per_row,
           int per_row_coeffs, int clamp, void* stream) {
    switch (K) {
        case 1: return launch_k<T, 1>(x, coeffs, q, out, n, B, M,
                                      blocks_per_row, per_row_coeffs, clamp,
                                      stream);
        case 2: return launch_k<T, 2>(x, coeffs, q, out, n, B, M,
                                      blocks_per_row, per_row_coeffs, clamp,
                                      stream);
        case 3: return launch_k<T, 3>(x, coeffs, q, out, n, B, M,
                                      blocks_per_row, per_row_coeffs, clamp,
                                      stream);
        case 4: return launch_k<T, 4>(x, coeffs, q, out, n, B, M,
                                      blocks_per_row, per_row_coeffs, clamp,
                                      stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// Plain C entry points for ctypes. The caller validates shapes and sizes;
// the return value is cudaGetLastError() right after the launch, or
// cudaErrorInvalidValue for a channel count outside 1..4.
extern "C" int ppoly_eval_f64(const void* x, const void* coeffs, const void* q,
                              void* out, int n, int K, long long B,
                              long long M, long long blocks_per_row,
                              int per_row_coeffs, int clamp, void* stream) {
    return launch<double>(x, coeffs, q, out, n, K, B, M, blocks_per_row,
                          per_row_coeffs, clamp, stream);
}

extern "C" int ppoly_eval_f32(const void* x, const void* coeffs, const void* q,
                              void* out, int n, int K, long long B,
                              long long M, long long blocks_per_row,
                              int per_row_coeffs, int clamp, void* stream) {
    return launch<float>(x, coeffs, q, out, n, K, B, M, blocks_per_row,
                         per_row_coeffs, clamp, stream);
}
