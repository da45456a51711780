// Chebyshev series by Clenshaw's recurrence for Hopper (sm_90a): up to two
// series over one query set, and the reduction its gradient needs.
//
// No TPU kernel: the JAX package's chebyshev_eval
// (victor_tpu/ops/splines.py:494-502) is plain jnp, which XLA fuses into one
// pass. PyTorch runs the same recurrence eagerly, one whole-tensor launch per
// product, difference and sum: about 159 launches per series and, at the
// fast streaming mode's (64, 50 x 3000) f64, some 55 GB of device memory
// traffic per chunk. chebyshev_kernel is that fusion, written by hand:
//
//   coef[s]  (B, K)   series s in 0 .. S-1 (S <= 2), K terms per row
//   a[s], b[s] (B,)   its domain [a, b]
//   q        (B, M)   queries, shared by the row's series
//   out[s]   (B, M)
//
// per query and series:
//
//   u   = clip((2 q - (a + b)) / (b - a), -1, 1)
//   b1  = b2 = 0;  for k = K-1 .. 1:  b1, b2 = ((2 u) * b1 - b2) + c_k, b1
//   out = (u * b1 - b2) + c_0
//
// The same bits as the plain recurrence (kernels/chebyshev.py), which is the
// JAX package's step for step, for every input: each product, difference and
// sum is rounded on its own (__dmul_rn, __dsub_rn, __dadd_rn; the _rn float
// intrinsics in f32), which keeps nvcc from contracting them into FMAs; the
// division is IEEE (__ddiv_rn, __fdiv_rn); the clip is two selects, so a NaN
// query stays NaN (fmin/fmax would return the bound); and the first step
// runs on b1 = b2 = 0 as the plain loop does, so even the sign of a zero
// term comes out the same.
//
// Bound: DP operations. At (64, 50 x 3000) f64 with S = 2 and K = 49 a chunk
// reads q once and writes two outputs: 230 MB, 0.069 ms at 3.35 TB/s. It
// needs about 2.9 G separately rounded f64 operations (2 series x 48 steps x
// 3, with the setup): 0.17 ms at the H100 SXM's 17 T f64 instructions per
// second (34 TFLOP/s outside the tensor cores, an FMA counted as two). So
// the design keeps the f64 pipes fed and everything else off them:
//
// * Coefficients and domains are read once per block. A block serves one
//   row: it stages the row's S x K coefficients in shared memory, and each
//   step reads them as a warp-uniform broadcast; a + b and b - a are formed
//   once per thread.
// * Independent chains. Each thread takes two neighbouring queries (one
//   16-byte double2 load, float2 in f32) and runs both series on both,
//   interleaved: four dependency chains per thread hide the f64 latency,
//   with b1 and b2 in registers throughout.
// * Vector loads and stores where M is even and q and the outputs are
//   aligned to the pair (then every row starts aligned); otherwise scalar
//   accesses with the ragged last query masked.
//
// The gradient (kernels/chebyshev.py composes it) needs one more operation
// that is not an evaluation: d out / d c_k = T_k(u), so the coefficients'
// gradient is the reduction
//
//   dcoef[row, k] = sum_m g[row, m] T_k(u[row, m]),
//
// chebyshev_transpose_kernel. Each thread holds POINTS queries of its
// block's tile and steps T_k = (2u) T_{k-1} - T_{k-2} for all of them at
// once; per k the thread's sum over its queries is summed over the warp by
// a butterfly of shuffles, and lane 0 adds it to the warp's row of shared
// memory. At the end the block sums its warps in a fixed order and writes
// one partial per (row, block); the wrapper sums the partials. No atomics:
// the same inputs give the same bits.
//
// Rows and tiles share gridDim.x; a block strides over its row, and offsets
// are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;      // must match kernels/chebyshev.py
constexpr int WARPS = THREADS / 32;
constexpr int MAX_TERMS = 128;    // K <= MAX_TERMS; the wrapper checks
constexpr int MAX_SERIES = 2;
constexpr int POINTS = 4;         // queries per thread per pass (transpose);
                                  // must match kernels/chebyshev.py

__device__ __forceinline__ double mul_rn(double x, double y) { return __dmul_rn(x, y); }
__device__ __forceinline__ float mul_rn(float x, float y) { return __fmul_rn(x, y); }
__device__ __forceinline__ double add_rn(double x, double y) { return __dadd_rn(x, y); }
__device__ __forceinline__ float add_rn(float x, float y) { return __fadd_rn(x, y); }
__device__ __forceinline__ double sub_rn(double x, double y) { return __dsub_rn(x, y); }
__device__ __forceinline__ float sub_rn(float x, float y) { return __fsub_rn(x, y); }
__device__ __forceinline__ double div_rn(double x, double y) { return __ddiv_rn(x, y); }
__device__ __forceinline__ float div_rn(float x, float y) { return __fdiv_rn(x, y); }

template <typename T> struct Pair;
template <> struct Pair<double> { using type = double2; };
template <> struct Pair<float> { using type = float2; };

// clip(u, -1, 1) with selects: NaN stays NaN
template <typename T>
__device__ __forceinline__ T clip_unit(T u) {
    u = (u < T(-1)) ? T(-1) : u;
    return (u > T(1)) ? T(1) : u;
}

// the pointers of up to MAX_SERIES series, passed by value
template <typename T>
struct Series {
    const T* coef[MAX_SERIES];
    const T* a[MAX_SERIES];
    const T* b[MAX_SERIES];
    T* out[MAX_SERIES];
};

template <typename T, int S>
__global__ void __launch_bounds__(THREADS)
chebyshev_kernel(Series<T> series, const T* __restrict__ q, int K, int64_t M,
                 int64_t blocks_per_row, int vec) {
    using V = typename Pair<T>::type;
    __shared__ T sc[S * MAX_TERMS];

    const int64_t row = blockIdx.x / blocks_per_row;
    const int64_t tile = blockIdx.x - row * blocks_per_row;
#pragma unroll
    for (int s = 0; s < S; ++s)
        for (int i = threadIdx.x; i < K; i += THREADS)
            sc[s * K + i] = series.coef[s][row * K + i];
    T sum[S], width[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
        const T lo = series.a[s][row], hi = series.b[s][row];
        sum[s] = add_rn(lo, hi);
        width[s] = sub_rn(hi, lo);
    }
    __syncthreads();

    const T* qr = q + row * M;
    const int64_t pairs = (M + 1) >> 1;
    for (int64_t p = tile * THREADS + threadIdx.x; p < pairs;
         p += blocks_per_row * THREADS) {
        const int64_t j = 2 * p;
        const bool second = j + 1 < M;
        T x[2];
        if (vec) {
            const V v = reinterpret_cast<const V*>(qr)[p];
            x[0] = v.x;
            x[1] = v.y;
        } else {
            x[0] = qr[j];
            x[1] = second ? qr[j + 1] : T(0);
        }
        T u[S][2], u2[S][2], b1[S][2], b2[S][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const T twice = mul_rn(T(2), x[i]);
#pragma unroll
            for (int s = 0; s < S; ++s) {
                u[s][i] = clip_unit(div_rn(sub_rn(twice, sum[s]), width[s]));
                u2[s][i] = mul_rn(T(2), u[s][i]);
                b1[s][i] = T(0);
                b2[s][i] = T(0);
            }
        }
#pragma unroll 4
        for (int k = K - 1; k > 0; --k) {
#pragma unroll
            for (int s = 0; s < S; ++s) {
                const T c = sc[s * K + k];
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    const T next = add_rn(
                        sub_rn(mul_rn(u2[s][i], b1[s][i]), b2[s][i]), c);
                    b2[s][i] = b1[s][i];
                    b1[s][i] = next;
                }
            }
        }
#pragma unroll
        for (int s = 0; s < S; ++s) {
            const T c0 = sc[s * K];
            T r[2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
                r[i] = add_rn(sub_rn(mul_rn(u[s][i], b1[s][i]), b2[s][i]),
                              c0);
            T* orow = series.out[s] + row * M;
            if (vec) {
                V v;
                v.x = r[0];
                v.y = r[1];
                reinterpret_cast<V*>(orow)[p] = v;
            } else {
                orow[j] = r[0];
                if (second) orow[j + 1] = r[1];
            }
        }
    }
}

// the sum over a warp, by a butterfly in a fixed order: every lane gets it
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
    for (int lane = 16; lane > 0; lane >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, lane);
    return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
chebyshev_transpose_kernel(const T* __restrict__ g, const T* __restrict__ a,
                           const T* __restrict__ b, const T* __restrict__ q,
                           T* __restrict__ partial, int K, int64_t M,
                           int64_t blocks_per_row) {
    __shared__ T acc[WARPS][MAX_TERMS];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int i = threadIdx.x; i < WARPS * MAX_TERMS; i += THREADS)
        (&acc[0][0])[i] = T(0);
    const int64_t row = blockIdx.x / blocks_per_row;
    const int64_t tile = blockIdx.x - row * blocks_per_row;
    const T lo = a[row], hi = b[row];
    const T sum = lo + hi, width = hi - lo;
    const T* qr = q + row * M;
    const T* gr = g + row * M;
    __syncthreads();

    constexpr int64_t SPAN = (int64_t)THREADS * POINTS;
    // the same trip count for every thread of the block: the shuffles below
    // need the whole warp
    for (int64_t base = tile * SPAN; base < M; base += blocks_per_row * SPAN) {
        T u2[POINTS], gv[POINTS], t0[POINTS], t1[POINTS];
#pragma unroll
        for (int i = 0; i < POINTS; ++i) {
            const int64_t j = base + (int64_t)i * THREADS + threadIdx.x;
            T u = T(0);
            gv[i] = T(0);          // a query past the row adds nothing
            if (j < M) {
                u = clip_unit((T(2) * qr[j] - sum) / width);
                gv[i] = gr[j];
            }
            u2[i] = T(2) * u;
            t0[i] = T(1);
            t1[i] = u;
        }
        T v = T(0);
#pragma unroll
        for (int i = 0; i < POINTS; ++i) v += gv[i];
        v = warp_sum(v);
        if (lane == 0) acc[warp][0] += v;
        if (K > 1) {
            v = T(0);
#pragma unroll
            for (int i = 0; i < POINTS; ++i) v += gv[i] * t1[i];
            v = warp_sum(v);
            if (lane == 0) acc[warp][1] += v;
        }
        for (int k = 2; k < K; ++k) {
            v = T(0);
#pragma unroll
            for (int i = 0; i < POINTS; ++i) {
                const T next = u2[i] * t1[i] - t0[i];
                t0[i] = t1[i];
                t1[i] = next;
                v += gv[i] * next;
            }
            v = warp_sum(v);
            if (lane == 0) acc[warp][k] += v;
        }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < K; k += THREADS) {
        T s = T(0);
#pragma unroll
        for (int w = 0; w < WARPS; ++w) s += acc[w][k];
        partial[blockIdx.x * (int64_t)K + k] = s;
    }
}

template <typename T>
int launch(const void* const* coef, const void* const* a,
           const void* const* b, void* const* out, const void* q, int S,
           int K, long long B, long long M, long long blocks_per_row,
           int vec, void* stream) {
    if (S < 1 || S > MAX_SERIES || K < 1 || K > MAX_TERMS)
        return (int)cudaErrorInvalidValue;
    Series<T> series = {};
    for (int s = 0; s < S; ++s) {
        series.coef[s] = static_cast<const T*>(coef[s]);
        series.a[s] = static_cast<const T*>(a[s]);
        series.b[s] = static_cast<const T*>(b[s]);
        series.out[s] = static_cast<T*>(out[s]);
    }
    const dim3 grid((unsigned int)(B * blocks_per_row));
    const cudaStream_t st = (cudaStream_t)stream;
    const T* qq = static_cast<const T*>(q);
    if (S == 1)
        chebyshev_kernel<T, 1><<<grid, THREADS, 0, st>>>(
            series, qq, K, (int64_t)M, (int64_t)blocks_per_row, vec);
    else
        chebyshev_kernel<T, 2><<<grid, THREADS, 0, st>>>(
            series, qq, K, (int64_t)M, (int64_t)blocks_per_row, vec);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_transpose(const void* g, const void* a, const void* b,
                     const void* q, void* partial, int K, long long B,
                     long long M, long long blocks_per_row, void* stream) {
    if (K < 1 || K > MAX_TERMS) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned int)(B * blocks_per_row));
    chebyshev_transpose_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        static_cast<const T*>(g), static_cast<const T*>(a),
        static_cast<const T*>(b), static_cast<const T*>(q),
        static_cast<T*>(partial), K, (int64_t)M, (int64_t)blocks_per_row);
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes. The caller validates shapes, sizes and
// alignment (`vec`); the return value is cudaGetLastError() right after the
// launch, or cudaErrorInvalidValue for an S or K out of range. coef, a, b
// and out are arrays of S pointers.
#define CHEBYSHEV_ENTRY(NAME, T)                                              \
    extern "C" int NAME(const void* const* coef, const void* const* a,       \
                        const void* const* b, void* const* out,              \
                        const void* q, int S, int K, long long B,            \
                        long long M, long long blocks_per_row, int vec,      \
                        void* stream) {                                       \
        return launch<T>(coef, a, b, out, q, S, K, B, M, blocks_per_row,     \
                         vec, stream);                                        \
    }

// partial is (B, blocks_per_row, K): one sum per row and block
#define TRANSPOSE_ENTRY(NAME, T)                                              \
    extern "C" int NAME(const void* g, const void* a, const void* b,         \
                        const void* q, void* partial, int K, long long B,    \
                        long long M, long long blocks_per_row,               \
                        void* stream) {                                       \
        return launch_transpose<T>(g, a, b, q, partial, K, B, M,             \
                                   blocks_per_row, stream);                   \
    }

CHEBYSHEV_ENTRY(chebyshev_eval_f64, double)
CHEBYSHEV_ENTRY(chebyshev_eval_f32, float)
TRANSPOSE_ENTRY(chebyshev_transpose_f64, double)
TRANSPOSE_ENTRY(chebyshev_transpose_f32, float)
