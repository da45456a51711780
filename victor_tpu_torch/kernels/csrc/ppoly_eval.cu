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
// operand and would turn a NaN query into x[0]. The interval is found by
// binary lifting over the knots (the largest i in [0, n-2] with x[i] <= qq,
// 0 when there is none or qq is NaN), which is the clip above for sorted x.
// K is a template argument, so each channel's arithmetic is the same
// instruction sequence whatever K and whichever path below: channel k of a
// K-channel call equals a 1-channel call on table k bit for bit. nvcc
// contracts c3*t + c2 into an FMA, so results differ from the plain PyTorch
// version (separately rounded multiply and add) by a few ulp.
//
// Bound: bytes. Per query the kernel reads q and writes K outputs ((1 + K) * 8
// B in f64) against about 5 compares and 6K flops, so the card's memory rate
// is the limit to aim at. On the H100 the first thing in the way is the
// shared-memory pipe, not the loads in flight. Measured on an H100 SXM at
// 700 W at (64, 150000) f64: one query per thread with a bounds-checked
// search, x[i] read again for t and four scalar coefficient loads reached 59%
// of the byte bound; a copy kernel of the same shape 75-83%, and the same
// kernel without its search 75-83%. So the design spends few shared-memory
// wavefronts per query and keeps enough loads in flight around them:
//
// * Fewer shared-memory accesses. The search keys sit in their own array,
//   padded with NaN up to twice the first lifting step, so a step is one
//   load and one compare with no bounds check (NaN <= qq is false for every
//   qq, +inf included); the key of the chosen interval is carried out of the
//   search, so t = qq - x[i] needs no further load. In f64 a channel's
//   coefficients are split into a (c0, c1) and a (c2, c3) array of 16-byte
//   pairs, which halves the stride between intervals and with it the bank
//   conflicts of the two coefficient loads; f32 keeps (c0..c3) in one 16-byte
//   load.
// * Vector loads issued before the search. A thread owns LOADS = 1 or 2
//   vectors of 16 bytes (double2 / float4) per tile and issues them all
//   before it searches any; the j-th vectors of a block's threads are one
//   contiguous run, so each warp-wide load and store is coalesced. Query
//   loads and output stores carry the evict-first hint (ld.global.cs,
//   st.global.cs): nothing in this kernel touches them twice, and on the
//   samplers' shape with L2 cold the hinted loads measured 3% faster.
// * A whole-wave grid. The wrapper launches (SM count) x (blocks an SM holds)
//   blocks, all resident at once (__launch_bounds__ caps the registers so
//   that 8 blocks fit with one vector per thread, 6 with two: tighter caps
//   spilled), or one block per tile when there are fewer tiles. Blocks walk
//   the (row, tile) pairs grid-stride, so at any moment the card streams one
//   contiguous window of q: contiguous per-block shares of the same grid
//   measured 6 points of the bound lower. The plan takes LOADS = 2 when the
//   call has at least four such waves of work, else 1, so that a small call
//   (the samplers' (8, 150000)) spreads over every thread in fewer rounds.
// * The table behind the first loads. A block issues its tile's query loads,
//   then stages the row's tables in shared memory (every staging load issued
//   before the first store), so the table's latency overlaps the queries'
//   instead of adding to it; it re-stages only when its row changes (per-row
//   tables) and never with one shared table.
// * Small rows take one tile each. A row shorter than a tile (the
//   Chebyshev-node lookups, 25 or 49 queries) is one block's tile, mostly
//   idle threads. Packing such rows several to a block, one warp each, timed
//   the same on an H100 SXM at 700 W (3.0 us at 8 rows of 49): such a call is
//   one launch's latency, whatever the block shape.
//
// The vector path needs q and out 16-byte aligned and M a multiple of the
// vector width, so that every row starts aligned; the wrapper's launch plan
// (kernels/ppoly.py::launch_plan) sends any other call (a q at an odd storage
// offset, an odd M) down the scalar path of the same kernel. Offsets are
// 64-bit: B*K*M passes 2^31 for an unchunked batch of about 14k points. The
// grid is the wrapper's choice: any grid covers every tile.
//
// Shared memory of one staged table (the wrapper's _smem_bytes): K channels
// of 4(n-1) coefficients, S = max(2 * first step, 1) search keys, x[n-1].
//
// The backward (ppoly_bwd_chunks, ppoly_bwd_reduce) follows the forward's
// launch code, with its own design note, and its second derivatives
// (ppoly_2nd_chunks) follow the backward, with theirs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;        // threads per block
// resident blocks per SM that the wrapper's grid assumes, with 1 and with 2
// vectors per thread (registers capped at 32 and 40 by __launch_bounds__);
// the wrapper reads these through ppoly_eval_geometry
constexpr int BLOCKS_PER_SM_1 = 8;
constexpr int BLOCKS_PER_SM_2 = 6;

template <typename T> __device__ __forceinline__ T quiet_nan();
template <> __device__ __forceinline__ double quiet_nan<double>() {
    return __longlong_as_double(0x7ff8000000000000LL);
}
template <> __device__ __forceinline__ float quiet_nan<float>() {
    return __int_as_float(0x7fc00000);
}

// Loads and stores of VEC consecutive elements of q and out, both with the
// evict-first hint (ld.global.cs, st.global.cs): each is touched once here.
template <typename T, int VEC> struct Vec;

template <> struct Vec<double, 2> {
    static __device__ __forceinline__ void load(const double* p, double* a) {
        const double2 v = __ldcs(reinterpret_cast<const double2*>(p));
        a[0] = v.x;
        a[1] = v.y;
    }
    static __device__ __forceinline__ void store(double* p, const double* a) {
        __stcs(reinterpret_cast<double2*>(p), make_double2(a[0], a[1]));
    }
};

template <> struct Vec<float, 4> {
    static __device__ __forceinline__ void load(const float* p, float* a) {
        const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
        a[0] = v.x;
        a[1] = v.y;
        a[2] = v.z;
        a[3] = v.w;
    }
    static __device__ __forceinline__ void store(float* p, const float* a) {
        __stcs(reinterpret_cast<float4*>(p),
               make_float4(a[0], a[1], a[2], a[3]));
    }
};

template <typename T> struct Vec<T, 1> {
    static __device__ __forceinline__ void load(const T* p, T* a) {
        a[0] = __ldcs(p);
    }
    static __device__ __forceinline__ void store(T* p, const T* a) {
        __stcs(p, a[0]);
    }
};

// Horner's rule at offset t of the located query qq, plus the NaN term: the
// forward's value. Every kernel here that evaluates a table calls this, so
// that nvcc contracts it into the same FMAs everywhere.
template <typename T>
__device__ __forceinline__ T horner(T c0, T c1, T c2, T c3, T t, T qq) {
    return ((c3 * t + c2) * t + c1) * t + c0 + (qq - qq);
}

// The staged table of one row: K channels of coefficients, then the search
// keys, then x[n-1]. f64 channels are split into (c0, c1) and (c2, c3) pair
// arrays; f32 channels keep (c0..c3) together.
template <typename T>
struct Table {
    int n, table, keys;     // knots, coefficients per channel, search keys
    int step;               // first step of the binary lifting

    __device__ __forceinline__ explicit Table(int n_)
        : n(n_), table(4 * (n_ - 1)) {
        step = n > 2 ? 1 << (31 - __clz(n - 2)) : 0;
        keys = step > 0 ? 2 * step : 1;
    }

    // Copy K channels of `crow` and the knots into `sm` (threads tid, tid +
    // nt, ... of the copy), U loads in flight per thread: each pass issues
    // its loads before its stores.
    template <int K, int U>
    __device__ __forceinline__ void stage(T* sm, const T* __restrict__ x,
                                          const T* __restrict__ crow, int tid,
                                          int nt) const {
        stage_channels<K, U>(sm, crow, tid, nt);
        T* key = sm + K * table;
        for (int base = tid; base <= keys; base += U * nt) {
            T v[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int i = base + u * nt;
                const int src = i < keys ? i : n - 1;   // x[n-1] last
                v[u] = (i <= keys && (i == keys || i <= n - 2))
                    ? __ldg(x + src) : quiet_nan<T>();
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int i = base + u * nt;
                if (i <= keys) key[i] = v[u];
            }
        }
    }

    // The K channels alone: f64 coefficient e of interval iv goes to the
    // (c0, c1) or the (c2, c3) pair array of its channel.
    template <int K, int U>
    __device__ __forceinline__ void stage_channels(T* sm,
                                                   const T* __restrict__ crow,
                                                   int tid, int nt) const {
#pragma unroll
        for (int k = 0; k < K; ++k) {
            for (int base = tid; base < table; base += U * nt) {
                T v[U];
#pragma unroll
                for (int u = 0; u < U; ++u) {
                    const int i = base + u * nt;
                    if (i < table) v[u] = __ldg(crow + k * table + i);
                }
#pragma unroll
                for (int u = 0; u < U; ++u) {
                    const int i = base + u * nt;
                    if (i >= table) continue;
                    const int slot = sizeof(T) == 8
                        ? (i & 2) * (table >> 2) + 2 * (i >> 2) + (i & 1) : i;
                    sm[k * table + slot] = v[u];
                }
            }
        }
    }

    // Clamp P queries into [x[0], x[n-1]] with selects and find each one's
    // interval and its key x[i]. The lifting steps are the outer loop, so the
    // P searches interleave.
    template <int K, int P>
    __device__ __forceinline__ void locate(const T* sm, int clamp, T* qq,
                                           int* idx, T* xl) const {
        const T* key = sm + K * table;
        const T x0 = key[0];
        const T xn = key[keys];
#pragma unroll
        for (int p = 0; p < P; ++p) {
            if (clamp) {
                qq[p] = (qq[p] < x0) ? x0 : qq[p];
                qq[p] = (qq[p] > xn) ? xn : qq[p];
            }
            idx[p] = 0;
            xl[p] = x0;
        }
        for (int s = step; s > 0; s >>= 1) {
#pragma unroll
            for (int p = 0; p < P; ++p) {
                const T xc = key[idx[p] + s];   // NaN past x[n-2]: never taken
                const bool take = xc <= qq[p];
                idx[p] = take ? idx[p] + s : idx[p];
                xl[p] = take ? xc : xl[p];
            }
        }
    }

    // Channel k at a located query: Horner's rule plus the NaN term.
    __device__ __forceinline__ T value(const T* sm, int k, int i, T xi,
                                       T qq) const {
        T c0, c1, c2, c3;
        coeffs(sm + k * table, i, c0, c1, c2, c3);
        return horner(c0, c1, c2, c3, qq - xi, qq);
    }

    __device__ __forceinline__ void coeffs(const T* c, int i, T& c0, T& c1,
                                           T& c2, T& c3) const;
};

template <>
__device__ __forceinline__ void Table<double>::coeffs(
        const double* c, int i, double& c0, double& c1, double& c2,
        double& c3) const {
    const double2 lo = reinterpret_cast<const double2*>(c)[i];
    const double2 hi = reinterpret_cast<const double2*>(c + (table >> 1))[i];
    c0 = lo.x; c1 = lo.y; c2 = hi.x; c3 = hi.y;
}

template <>
__device__ __forceinline__ void Table<float>::coeffs(
        const float* c, int i, float& c0, float& c1, float& c2,
        float& c3) const {
    const float4 v = reinterpret_cast<const float4*>(c)[i];
    c0 = v.x; c1 = v.y; c2 = v.z; c3 = v.w;
}

// Tiles of THREADS * LOADS vectors within a row, walked grid-stride by a
// grid of at most one wave.
template <typename T, int K, int VEC, int LOADS>
__global__ void __launch_bounds__(THREADS, LOADS == 1 ? BLOCKS_PER_SM_1
                                                      : BLOCKS_PER_SM_2)
ppoly_tiles(const T* __restrict__ x, const T* __restrict__ coeffs,
            const T* __restrict__ q, T* __restrict__ out, int n, int64_t B,
            int64_t M, int per_row_coeffs, int clamp) {
    constexpr int P = LOADS * VEC;
    constexpr int TILE = THREADS * LOADS;        // vectors
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* sm = reinterpret_cast<T*>(smem_raw);
    const Table<T> tab(n);

    const int64_t Mv = M / VEC;                   // vectors per row
    const int64_t per_row = (Mv + TILE - 1) / TILE;
    const int64_t tiles = B * per_row;
    int64_t staged = -1;
    for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int64_t row = t / per_row;
        const int64_t first = row * Mv + (t - row * per_row) * TILE;
        const int64_t row_end = (row + 1) * Mv;
        T qq[P];
#pragma unroll
        for (int j = 0; j < LOADS; ++j) {
            const int64_t v = first + j * THREADS + threadIdx.x;
#pragma unroll
            for (int e = 0; e < VEC; ++e) qq[j * VEC + e] = T(0);
            if (v < row_end) Vec<T, VEC>::load(q + v * VEC, qq + j * VEC);
        }
        const int64_t want = per_row_coeffs ? row : 0;
        if (want != staged) {                    // uniform across the block
            if (staged >= 0) __syncthreads();    // the old table is done with
            tab.template stage<K, 2>(sm, x, coeffs + want * K * tab.table,
                                     threadIdx.x, THREADS);
            __syncthreads();
            staged = want;
        }
        int idx[P];
        T xl[P];
        tab.template locate<K, P>(sm, clamp, qq, idx, xl);
        T* orow = out + row * (K - 1) * M;       // + k * M + flat element
#pragma unroll
        for (int j = 0; j < LOADS; ++j) {
            const int64_t v = first + j * THREADS + threadIdx.x;
            if (v >= row_end) continue;
#pragma unroll
            for (int k = 0; k < K; ++k) {
                T o[VEC];
#pragma unroll
                for (int e = 0; e < VEC; ++e)
                    o[e] = tab.value(sm, k, idx[j * VEC + e], xl[j * VEC + e],
                                     qq[j * VEC + e]);
                Vec<T, VEC>::store(orow + k * M + v * VEC, o);
            }
        }
    }
}

template <typename T, int K, int VEC>
void launch_tiles(int loads, int grid, int smem, cudaStream_t s, const T* x,
                  const T* c, const T* q, T* o, int n, long long B,
                  long long M, int per_row_coeffs, int clamp) {
    if (loads == 2)
        ppoly_tiles<T, K, VEC, 2><<<grid, THREADS, smem, s>>>(
            x, c, q, o, n, B, M, per_row_coeffs, clamp);
    else
        ppoly_tiles<T, K, VEC, 1><<<grid, THREADS, smem, s>>>(
            x, c, q, o, n, B, M, per_row_coeffs, clamp);
}

template <typename T, int K>
int launch_k(const void* x, const void* coeffs, const void* q, void* out,
             int n, long long B, long long M, int per_row_coeffs, int clamp,
             int vec, int loads, int grid, int smem, void* stream) {
    const T* xt = static_cast<const T*>(x);
    const T* ct = static_cast<const T*>(coeffs);
    const T* qt = static_cast<const T*>(q);
    T* ot = static_cast<T*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    constexpr int VW = 16 / sizeof(T);
    if ((loads != 1 && loads != 2) || grid < 1)
        return (int)cudaErrorInvalidValue;
    if (vec == VW)
        launch_tiles<T, K, VW>(loads, grid, smem, s, xt, ct, qt, ot, n, B, M,
                               per_row_coeffs, clamp);
    else if (vec == 1)
        launch_tiles<T, K, 1>(loads, grid, smem, s, xt, ct, qt, ot, n, B, M,
                              per_row_coeffs, clamp);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* coeffs, const void* q, void* out,
           int n, int K, long long B, long long M, int per_row_coeffs,
           int clamp, int vec, int loads, int grid, int smem, void* stream) {
    switch (K) {
        case 1: return launch_k<T, 1>(x, coeffs, q, out, n, B, M,
                                      per_row_coeffs, clamp, vec, loads, grid,
                                      smem, stream);
        case 2: return launch_k<T, 2>(x, coeffs, q, out, n, B, M,
                                      per_row_coeffs, clamp, vec, loads, grid,
                                      smem, stream);
        case 3: return launch_k<T, 3>(x, coeffs, q, out, n, B, M,
                                      per_row_coeffs, clamp, vec, loads, grid,
                                      smem, stream);
        case 4: return launch_k<T, 4>(x, coeffs, q, out, n, B, M,
                                      per_row_coeffs, clamp, vec, loads, grid,
                                      smem, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

// ---------------------------------------------------------------------------
// The backward: the vector-Jacobian product of the function above.
//
// Neither Pallas kernel of the JAX package had a VJP: victor_tpu
// differentiates ppoly_eval (its 'gather' strategy on the CPU, the masksum on
// the TPU) with XLA's autodiff. This is that gradient for the kernel above,
// written by hand. Given grad_out g (B, K, M) it returns
//
//   dq[b, m]   = sum_k g[b,k,m] * ((3 c3 t + 2 c2) t + c1) * f(q)
//   dc[r,k,i]  = sum over the queries m of the rows b that read table r with
//                interval i of g[b,k,m] * (1, t, t^2, t^3)
//
// with c = coeffs[r, k, i], t = qq - x[i] as in the forward, f = 1 inside
// (x[0], x[n-1]), 0.5 at either bound (jnp.clip's derivative, JAX's max and
// min halving at ties), 0 outside, and f = 1 without clamp. A NaN query
// takes the last interval, n-2, where torch.searchsorted and JAX's
// searchsorted (NaN sorts last) put it and its NaN reaches dc[.., n-2, 1..3]
// (the forward's search leaves it in interval 0, where the value is NaN
// all the same). Rows that share one table (Bc = 1) all sum into it.
//
// Determinism. The same inputs give the same bits on every run: no floating-
// point atomics anywhere. Every sum runs in a fixed order:
// * Within a warp, the lanes whose queries fall in one interval find each
//   other with __match_any_sync and each sums the group's terms by shuffles
//   in ascending lane order; the group's lowest lane adds the sum into the
//   warp's copy of the accumulators (a plain read-modify-write: distinct
//   groups touch distinct intervals). A warp walks its queries in a fixed
//   order, so each copy is a fixed sequence of additions.
// * Warps share copies only when shared memory is short (n near 1,024: one
//   copy of K*4(n-1) sums no longer fits eight times). Warps that share a
//   copy take fixed turns, each turn closed by __syncthreads.
// * A block owns one chunk of tiles of one row. At its end it adds its
//   copies in copy order and writes the chunk's partial sums to global
//   memory; a second kernel adds each table's partials in chunk order (32
//   strided lanes per element, then the 32 lane sums in order).
//
// Bound: bytes, as the forward: q and g read, dq written ((2 + K) * 8 B per
// query in f64), plus the partials (chunks x K*4(n-1), written and read
// once). Per query the reduction costs a warp match and up to 32 shuffle
// rounds when every lane shares an interval, so this simple design does not
// aim at the bound; its time stands in PERF.md.

constexpr int BWD_THREADS = 256;
constexpr int BWD_WARPS = BWD_THREADS / 32;
// resident blocks per SM that the wrapper's chunking aims to fill
constexpr int BWD_BLOCKS_PER_SM = 4;
constexpr int RED_LANES = 32;       // chunk lanes per element in the reduce

template <typename T> __device__ __forceinline__ T mul_rn(T a, T b);
template <> __device__ __forceinline__ double mul_rn<double>(double a,
                                                             double b) {
    return __dmul_rn(a, b);
}
template <> __device__ __forceinline__ float mul_rn<float>(float a, float b) {
    return __fmul_rn(a, b);
}

// The clip's derivative at q (jnp.clip's: 1 inside, 0.5 at a bound, 0
// outside and at NaN).
template <typename T>
__device__ __forceinline__ T clip_factor(T q, T x0, T xn) {
    return (q > x0 && q < xn) ? T(1) : (q == x0 || q == xn) ? T(0.5) : T(0);
}

// sum_k g_k p_k'(t), p_k's coefficients given by coeffs_of(k, c0, c1, c2,
// c3): the backward's dq before the clip factor, in its own op order (the
// second order calls it too, so that nvcc contracts it the same way).
template <typename T, int K, typename Coeffs>
__device__ __forceinline__ T slope_sum(const Coeffs& coeffs_of, const T* g,
                                       T t) {
    T d = T(0);
#pragma unroll
    for (int k = 0; k < K; ++k) {
        T c0, c1, c2, c3;
        coeffs_of(k, c0, c1, c2, c3);
        const T dk = g[k] * ((T(3) * c3 * t + T(2) * c2) * t + c1);
        d = k == 0 ? dk : d + dk;
    }
    return d;
}

// Add the terms w_k (1, t, t^2, t^3) of the active lanes, each at its
// interval i, into the warp's copy `mine` of the K x E sums: the lanes of
// one interval find each other with __match_any_sync, each sums its group's
// terms by shuffles in ascending lane order, and the group's lowest lane
// adds them in, the warps that share a copy taking `rounds` fixed turns.
// Called by every thread of the block.
template <typename T, int K>
__device__ __forceinline__ void add_terms(T* mine, int E, int rounds,
                                          int copies, int warp, int lane,
                                          bool active, int i, T t,
                                          const T* w) {
    const int ival = active ? i : -1;
    const unsigned group = __match_any_sync(0xffffffffu, ival);
    T s[K][4];
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[k][j] = T(0);
    unsigned rest = group;
    // every lane walks its own group in ascending lane order; the loop runs
    // to the largest group of the warp, all lanes together
    while (__any_sync(0xffffffffu, rest != 0u)) {
        const int src = rest ? __ffs(rest) - 1 : lane;
        const T ts = __shfl_sync(0xffffffffu, t, src);
#pragma unroll
        for (int k = 0; k < K; ++k) {
            T p = __shfl_sync(0xffffffffu, w[k], src);
            if (rest) {
                s[k][0] += p;
                p = mul_rn(p, ts);
                s[k][1] += p;
                p = mul_rn(p, ts);
                s[k][2] += p;
                p = mul_rn(p, ts);
                s[k][3] += p;
            }
        }
        rest &= rest - 1u;
    }
    const bool leader = active && lane == __ffs(group) - 1;
    for (int r = 0; r < rounds; ++r) {
        if (leader && warp / copies == r) {
#pragma unroll
            for (int k = 0; k < K; ++k)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    mine[k * E + 4 * i + j] += s[k][j];
        }
        if (rounds > 1) __syncthreads();
        else __syncwarp();
    }
}

// At a block's end: its copies of the KE sums added in copy order, written
// to the block's partial table.
template <typename T>
__device__ __forceinline__ void write_partial(const T* acc, T* partial,
                                              int KE, int copies) {
    __syncthreads();
    T* out = partial + (int64_t)blockIdx.x * KE;
    for (int e = threadIdx.x; e < KE; e += BWD_THREADS) {
        T v = acc[e];
        for (int c = 1; c < copies; ++c) v += acc[c * KE + e];
        out[e] = v;
    }
}

// One chunk per block: `tiles` tiles of BWD_THREADS queries of one row, one
// query per thread per tile. dq is skipped when null; DC: the coefficient
// sums are wanted, written to partial[chunk] (K * 4(n-1) values).
template <typename T, int K, bool DC>
__global__ void __launch_bounds__(BWD_THREADS)
ppoly_bwd_chunks(const T* __restrict__ x, const T* __restrict__ coeffs,
                 const T* __restrict__ q, const T* __restrict__ g,
                 T* __restrict__ dq, T* __restrict__ partial, int n,
                 int64_t M, int per_row_coeffs, int clamp, int tiles,
                 int chunks, int copies) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* sm = reinterpret_cast<T*>(smem_raw);
    const Table<T> tab(n);
    const int E = tab.table;                      // 4(n-1) sums per channel
    T* acc = sm + K * tab.table + tab.keys + 1;   // copies x K x E
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

    const int64_t row = blockIdx.x / chunks;
    const int64_t m0 = (blockIdx.x - row * chunks) * (int64_t)tiles *
                       BWD_THREADS;
    const int64_t m1 = m0 + (int64_t)tiles * BWD_THREADS < M
        ? m0 + (int64_t)tiles * BWD_THREADS : M;
    tab.template stage<K, 2>(sm, x, coeffs + (per_row_coeffs ? row : 0) * K *
                             tab.table, tid, BWD_THREADS);
    if (DC)
        for (int e = tid; e < copies * K * E; e += BWD_THREADS) acc[e] = T(0);
    __syncthreads();

    const T* key = sm + K * tab.table;
    const T x0 = key[0], xn = key[tab.keys];
    const int rounds = BWD_WARPS / copies;        // turns per shared copy
    T* mine = acc + (warp % copies) * K * E;
    for (int64_t base = m0; base < m1; base += BWD_THREADS) {   // uniform
        const int64_t m = base + tid;
        const bool active = m < m1;
        const T qv = active ? __ldcs(q + row * M + m) : T(0);
        T gk[K];
#pragma unroll
        for (int k = 0; k < K; ++k)
            gk[k] = active ? __ldcs(g + (row * K + k) * M + m) : T(0);
        T qq[1] = {qv};
        int idx[1];
        T xl[1];
        tab.template locate<K, 1>(sm, clamp, qq, idx, xl);
        if (qq[0] != qq[0]) idx[0] = n - 2;       // NaN sorts last
        const T t = qq[0] - xl[0];
        if (dq != nullptr && active) {
            T d = slope_sum<T, K>(
                [&](int k, T& c0, T& c1, T& c2, T& c3) {
                    tab.coeffs(sm + k * tab.table, idx[0], c0, c1, c2, c3);
                }, gk, t);
            if (clamp) d = d * clip_factor(qv, x0, xn);
            __stcs(dq + row * M + m, d);
        }
        if (DC)
            add_terms<T, K>(mine, E, rounds, copies, warp, lane, active,
                            idx[0], t, gk);
    }
    if (DC) write_partial(acc, partial, K * E, copies);
}

// dcoeffs[r] = the sum of the partials of the chunks that read table r, in
// chunk order: 32 chunk lanes per element, then their sums in lane order.
// SECOND: the second order's layout (0, S0, 2 S1, 3 S2) per interval, entry
// j > 0 the sum of partial entry j - 1 times j (PyTorch's rounding of 3 S2).
// grid (tables, ceil(KE / 32)), block (32, RED_LANES).
template <typename T, bool SECOND>
__global__ void __launch_bounds__(32 * RED_LANES)
ppoly_bwd_reduce(const T* __restrict__ partial, T* __restrict__ dcoeffs,
                 int KE, int chunks, int per_row_coeffs, int64_t all_chunks) {
    __shared__ T lanes[RED_LANES][33];
    const int64_t r = blockIdx.x;
    const int e = blockIdx.y * 32 + threadIdx.x;
    const int j = e & 3;
    const int src = SECOND ? e - 1 : e;
    const int64_t c0 = per_row_coeffs ? r * chunks : 0;
    const int64_t cn = per_row_coeffs ? chunks : all_chunks;
    T s = T(0);
    if (e < KE && (!SECOND || j > 0))
        for (int64_t c = threadIdx.y; c < cn; c += RED_LANES)
            s += partial[(c0 + c) * KE + src];
    lanes[threadIdx.y][threadIdx.x] = s;
    __syncthreads();
    if (threadIdx.y == 0 && e < KE) {
        T v = lanes[0][threadIdx.x];
        for (int y = 1; y < RED_LANES; ++y) v += lanes[y][threadIdx.x];
        if (SECOND) v = j == 0 ? T(0) : j == 1 ? v : mul_rn(T(j), v);
        dcoeffs[r * KE + e] = v;
    }
}

template <typename T, int K, bool DC>
int launch_bwd_k(const T* x, const T* c, const T* q, const T* g, T* dq,
                 T* dc, T* partial, int n, long long B, long long M,
                 int per_row_coeffs, int clamp, int tiles, int chunks,
                 int copies, int smem, cudaStream_t s) {
    auto kernel = ppoly_bwd_chunks<T, K, DC>;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
    }
    const long long grid = B * chunks;
    kernel<<<(unsigned)grid, BWD_THREADS, smem, s>>>(
        x, c, q, g, dq, partial, n, M, per_row_coeffs, clamp, tiles, chunks,
        copies);
    if (DC) {
        const int KE = K * 4 * (n - 1);
        const dim3 rgrid((unsigned)(per_row_coeffs ? B : 1),
                         (unsigned)((KE + 31) / 32));
        ppoly_bwd_reduce<T, false><<<rgrid, dim3(32, RED_LANES), 0, s>>>(
            partial, dc, KE, chunks, per_row_coeffs, grid);
    }
    return (int)cudaGetLastError();
}

template <typename T, int K>
int launch_bwd_dc(const T* x, const T* c, const T* q, const T* g, T* dq,
                  T* dc, T* partial, int n, long long B, long long M,
                  int per_row_coeffs, int clamp, int tiles, int chunks,
                  int copies, int smem, cudaStream_t s) {
    if (dc != nullptr)
        return launch_bwd_k<T, K, true>(x, c, q, g, dq, dc, partial, n, B, M,
                                        per_row_coeffs, clamp, tiles, chunks,
                                        copies, smem, s);
    return launch_bwd_k<T, K, false>(x, c, q, g, dq, dc, partial, n, B, M,
                                     per_row_coeffs, clamp, tiles, chunks,
                                     copies, smem, s);
}

template <typename T>
int launch_bwd(const void* x, const void* coeffs, const void* q,
               const void* g, void* dq, void* dcoeffs, void* partial, int n,
               int K, long long B, long long M, int per_row_coeffs, int clamp,
               int tiles, int chunks, int copies, int smem, void* stream) {
    const T* xt = static_cast<const T*>(x);
    const T* ct = static_cast<const T*>(coeffs);
    const T* qt = static_cast<const T*>(q);
    const T* gt = static_cast<const T*>(g);
    T* dqt = static_cast<T*>(dq);
    T* dct = static_cast<T*>(dcoeffs);
    T* pt = static_cast<T*>(partial);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (tiles < 1 || chunks < 1 || copies < 1 || BWD_WARPS % copies != 0 ||
        (dct != nullptr && pt == nullptr) || B * chunks > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    switch (K) {
        case 1: return launch_bwd_dc<T, 1>(xt, ct, qt, gt, dqt, dct, pt, n, B,
                                           M, per_row_coeffs, clamp, tiles,
                                           chunks, copies, smem, s);
        case 2: return launch_bwd_dc<T, 2>(xt, ct, qt, gt, dqt, dct, pt, n, B,
                                           M, per_row_coeffs, clamp, tiles,
                                           chunks, copies, smem, s);
        case 3: return launch_bwd_dc<T, 3>(xt, ct, qt, gt, dqt, dct, pt, n, B,
                                           M, per_row_coeffs, clamp, tiles,
                                           chunks, copies, smem, s);
        case 4: return launch_bwd_dc<T, 4>(xt, ct, qt, gt, dqt, dct, pt, n, B,
                                           M, per_row_coeffs, clamp, tiles,
                                           chunks, copies, smem, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// ---------------------------------------------------------------------------
// The second order: the derivatives of the backward above, in one pass.
//
// Neither TPU kernel had them: victor_tpu takes jax.hessian of ppoly_eval.
// Given the backward's grad_out g and the cotangents u (B, M) of dq and V
// (the coefficients' shape) of dcoeffs, either absent for 0, this is the
// gradient of <u, dq> + <V, dcoeffs> to (coeffs, q, grad_out). With c(q)
// the clip factor (1 without clamp), D = (c1, 2 c2, 3 c3, 0) the table of
// p' and p_V the polynomial with coefficients V:
//
//   d/dg[k]   = u c(q) p_k'(qq) + p_Vk(qq)
//   d/dq      = c(q) [c(q) sum_k u g_k p_k''(qq)] + c(q) sum_k g_k p_Vk'(qq)
//   d/dcoeffs = (0, S0, 2 S1, 3 S2),  S = sum over each interval's queries
//               of u c(q) g (1, t, t^2, t^3)
//
// d/dq and d/dg are NaN at an infinite query without clamp, where the
// forward is NaN. kernels/ppoly.py::ppoly_eval_second_order_composed
// computes the same terms with up to five launches of the two kernels above
// on tables derived elementwise by PyTorch and about 30 elementwise ops
// around them; this kernel gives its results bit for bit:
// * One search per query by the backward's rule (a NaN query in interval
//   n-2: the forward's terms are NaN there whatever the interval).
// * D is derived in registers from the staged coefficients, rounded as
//   PyTorch rounds it (2 c2 exact, 3 c3 one multiply); V is staged beside
//   the table when given. The forward's values and the backward's
//   derivative sums are the same device code (horner, slope_sum) on D and
//   V, so nvcc contracts them into the same FMAs.
// * Each product or sum that the composed path rounds as an op of its own
//   (u c(q), u g, (u c(q)) g, c(q) times a backward's dq, the sums of two
//   terms) is __dmul_rn / __dadd_rn (__f*_rn in f32), which nvcc never
//   contracts.
// * d/dcoeffs is the backward's reduction unchanged, with the weights
//   (u c(q)) g in place of g: the wrapper passes the backward's plan for
//   the same call (tiles, chunks, copies), so every sum runs in the same
//   order, and the reduce writes (0, S0, 2 S1, 3 S2).
// One launch per call, two with d/dcoeffs (chunks, then the reduce).
//
// Bound: bytes. Per query q, u and K g read, dq and K d/dg written ((3 + 2K)
// * 8 B in f64), against one search and about 40 flops per channel.
// Shared memory: the backward's (table, keys, copies of the sums), then V
// from the next 16-byte boundary.

template <typename T> __device__ __forceinline__ T add_rn(T a, T b);
template <> __device__ __forceinline__ double add_rn<double>(double a,
                                                             double b) {
    return __dadd_rn(a, b);
}
template <> __device__ __forceinline__ float add_rn<float>(float a, float b) {
    return __fadd_rn(a, b);
}

// One chunk per block, as ppoly_bwd_chunks. u null: no u terms (and no
// d/dcoeffs); V null: no V terms; dq, dg null: not wanted.
template <typename T, int K, bool DC>
__global__ void __launch_bounds__(BWD_THREADS)
ppoly_2nd_chunks(const T* __restrict__ x, const T* __restrict__ coeffs,
                 const T* __restrict__ q, const T* __restrict__ g,
                 const T* __restrict__ u, const T* __restrict__ V,
                 T* __restrict__ dq, T* __restrict__ dg,
                 T* __restrict__ partial, int n, int64_t M,
                 int per_row_coeffs, int clamp, int tiles, int chunks,
                 int copies) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* sm = reinterpret_cast<T*>(smem_raw);
    const Table<T> tab(n);
    const int E = tab.table;
    T* acc = sm + K * E + tab.keys + 1;           // copies x K x E
    constexpr int ALIGN = 16 / sizeof(T);
    T* vt = sm + (K * E + tab.keys + 1 + (DC ? copies * K * E : 0) +
                  ALIGN - 1) / ALIGN * ALIGN;     // V's K x E
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

    const int64_t row = blockIdx.x / chunks;
    const int64_t m0 = (blockIdx.x - row * chunks) * (int64_t)tiles *
                       BWD_THREADS;
    const int64_t m1 = m0 + (int64_t)tiles * BWD_THREADS < M
        ? m0 + (int64_t)tiles * BWD_THREADS : M;
    const int64_t trow = (per_row_coeffs ? row : 0) * K * E;
    tab.template stage<K, 2>(sm, x, coeffs + trow, tid, BWD_THREADS);
    if (V != nullptr)
        tab.template stage_channels<K, 2>(vt, V + trow, tid, BWD_THREADS);
    if (DC)
        for (int e = tid; e < copies * K * E; e += BWD_THREADS) acc[e] = T(0);
    __syncthreads();

    const T* key = sm + K * E;
    const T x0 = key[0], xn = key[tab.keys];
    const int rounds = BWD_WARPS / copies;
    T* mine = acc + (warp % copies) * K * E;
    for (int64_t base = m0; base < m1; base += BWD_THREADS) {   // uniform
        const int64_t m = base + tid;
        const bool active = m < m1;
        const int64_t at = row * M + m;
        const T qv = active ? __ldcs(q + at) : T(0);
        const T uv = active && u != nullptr ? __ldcs(u + at) : T(0);
        T gk[K];
#pragma unroll
        for (int k = 0; k < K; ++k)
            gk[k] = active ? __ldcs(g + (row * K + k) * M + m) : T(0);
        T qq[1] = {qv};
        int idx[1];
        T xl[1];
        tab.template locate<K, 1>(sm, clamp, qq, idx, xl);
        if (qq[0] != qq[0]) idx[0] = n - 2;       // NaN sorts last
        const int i = idx[0];
        const T t = qq[0] - xl[0];
        const T cq = clamp ? clip_factor(qv, x0, xn) : T(1);
        const T ucq = mul_rn(uv, cq);
        // the derivative table D and V at this query's interval
        const auto dtab = [&](int k, T& d0, T& d1, T& d2, T& d3) {
            T c0, c1, c2, c3;
            tab.coeffs(sm + k * E, i, c0, c1, c2, c3);
            d0 = c1;
            d1 = mul_rn(T(2), c2);
            d2 = mul_rn(T(3), c3);
            d3 = T(0);
        };
        const auto vtab = [&](int k, T& c0, T& c1, T& c2, T& c3) {
            tab.coeffs(vt + k * E, i, c0, c1, c2, c3);
        };
        const bool nan_out = !clamp && isinf(qv);   // the forward is NaN
        if (dq != nullptr && active) {
            T d = T(0);
            if (u != nullptr) {
                T ug[K];
#pragma unroll
                for (int k = 0; k < K; ++k) ug[k] = mul_rn(uv, gk[k]);
                d = slope_sum<T, K>(dtab, ug, t);
                if (clamp) d = mul_rn(cq, d * cq);
            }
            if (V != nullptr) {
                T dv = slope_sum<T, K>(vtab, gk, t);
                if (clamp) dv = dv * cq;
                d = u != nullptr ? add_rn(d, dv) : dv;
            }
            __stcs(dq + at, nan_out ? quiet_nan<T>() : d);
        }
        if (dg != nullptr && active) {
#pragma unroll
            for (int k = 0; k < K; ++k) {
                T o = T(0);
                if (u != nullptr) {
                    T d0, d1, d2, d3;
                    dtab(k, d0, d1, d2, d3);
                    o = mul_rn(ucq, horner(d0, d1, d2, d3, t, qq[0]));
                }
                if (V != nullptr) {
                    T c0, c1, c2, c3;
                    vtab(k, c0, c1, c2, c3);
                    const T pv = horner(c0, c1, c2, c3, t, qq[0]);
                    o = u != nullptr ? add_rn(o, pv) : pv;
                }
                __stcs(dg + (row * K + k) * M + m,
                       nan_out ? quiet_nan<T>() : o);
            }
        }
        if (DC) {
            T w[K];
#pragma unroll
            for (int k = 0; k < K; ++k) w[k] = mul_rn(ucq, gk[k]);
            add_terms<T, K>(mine, E, rounds, copies, warp, lane, active, i, t,
                            w);
        }
    }
    if (DC) write_partial(acc, partial, K * E, copies);
}

template <typename T, int K, bool DC>
int launch_2nd_k(const T* x, const T* c, const T* q, const T* g, const T* u,
                 const T* V, T* dq, T* dg, T* dc, T* partial, int n,
                 long long B, long long M, int per_row_coeffs, int clamp,
                 int tiles, int chunks, int copies, int smem,
                 cudaStream_t s) {
    auto kernel = ppoly_2nd_chunks<T, K, DC>;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
    }
    const long long grid = B * chunks;
    kernel<<<(unsigned)grid, BWD_THREADS, smem, s>>>(
        x, c, q, g, u, V, dq, dg, partial, n, M, per_row_coeffs, clamp, tiles,
        chunks, copies);
    if (DC) {
        const int KE = K * 4 * (n - 1);
        const dim3 rgrid((unsigned)(per_row_coeffs ? B : 1),
                         (unsigned)((KE + 31) / 32));
        ppoly_bwd_reduce<T, true><<<rgrid, dim3(32, RED_LANES), 0, s>>>(
            partial, dc, KE, chunks, per_row_coeffs, grid);
    }
    return (int)cudaGetLastError();
}

template <typename T, int K>
int launch_2nd_dc(const T* x, const T* c, const T* q, const T* g, const T* u,
                  const T* V, T* dq, T* dg, T* dc, T* partial, int n,
                  long long B, long long M, int per_row_coeffs, int clamp,
                  int tiles, int chunks, int copies, int smem,
                  cudaStream_t s) {
    if (dc != nullptr)
        return launch_2nd_k<T, K, true>(x, c, q, g, u, V, dq, dg, dc, partial,
                                        n, B, M, per_row_coeffs, clamp, tiles,
                                        chunks, copies, smem, s);
    return launch_2nd_k<T, K, false>(x, c, q, g, u, V, dq, dg, dc, partial, n,
                                     B, M, per_row_coeffs, clamp, tiles,
                                     chunks, copies, smem, s);
}

template <typename T>
int launch_2nd(const void* x, const void* coeffs, const void* q,
               const void* g, const void* u, const void* V, void* dq,
               void* dg, void* dcoeffs, void* partial, int n, int K,
               long long B, long long M, int per_row_coeffs, int clamp,
               int tiles, int chunks, int copies, int smem, void* stream) {
    const T* xt = static_cast<const T*>(x);
    const T* ct = static_cast<const T*>(coeffs);
    const T* qt = static_cast<const T*>(q);
    const T* gt = static_cast<const T*>(g);
    const T* ut = static_cast<const T*>(u);
    const T* vt = static_cast<const T*>(V);
    T* dqt = static_cast<T*>(dq);
    T* dgt = static_cast<T*>(dg);
    T* dct = static_cast<T*>(dcoeffs);
    T* pt = static_cast<T*>(partial);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (tiles < 1 || chunks < 1 || copies < 1 || BWD_WARPS % copies != 0 ||
        (dct != nullptr && (pt == nullptr || ut == nullptr)) ||
        B * chunks > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    switch (K) {
        case 1: return launch_2nd_dc<T, 1>(xt, ct, qt, gt, ut, vt, dqt, dgt,
                                           dct, pt, n, B, M, per_row_coeffs,
                                           clamp, tiles, chunks, copies, smem,
                                           s);
        case 2: return launch_2nd_dc<T, 2>(xt, ct, qt, gt, ut, vt, dqt, dgt,
                                           dct, pt, n, B, M, per_row_coeffs,
                                           clamp, tiles, chunks, copies, smem,
                                           s);
        case 3: return launch_2nd_dc<T, 3>(xt, ct, qt, gt, ut, vt, dqt, dgt,
                                           dct, pt, n, B, M, per_row_coeffs,
                                           clamp, tiles, chunks, copies, smem,
                                           s);
        case 4: return launch_2nd_dc<T, 4>(xt, ct, qt, gt, ut, vt, dqt, dgt,
                                           dct, pt, n, B, M, per_row_coeffs,
                                           clamp, tiles, chunks, copies, smem,
                                           s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// Plain C entry points for ctypes. The caller validates shapes and sizes and
// passes the launch plan (vector width 1 or 16 bytes' worth, 1 or 2 vectors
// per thread, grid, dynamic shared memory bytes). The return value is
// cudaGetLastError() right after the launch, or cudaErrorInvalidValue for a
// channel count outside 1..4 or a plan the kernel does not take.
extern "C" int ppoly_eval_f64(const void* x, const void* coeffs, const void* q,
                              void* out, int n, int K, long long B,
                              long long M, int per_row_coeffs, int clamp,
                              int vec, int loads, int grid, int smem,
                              void* stream) {
    return launch<double>(x, coeffs, q, out, n, K, B, M, per_row_coeffs, clamp,
                          vec, loads, grid, smem, stream);
}

extern "C" int ppoly_eval_f32(const void* x, const void* coeffs, const void* q,
                              void* out, int n, int K, long long B,
                              long long M, int per_row_coeffs, int clamp,
                              int vec, int loads, int grid, int smem,
                              void* stream) {
    return launch<float>(x, coeffs, q, out, n, K, B, M, per_row_coeffs, clamp,
                         vec, loads, grid, smem, stream);
}

// The backward (one call launches the chunk kernel and, when dcoeffs is
// wanted, the reduce). dq null: no dq; dcoeffs null: no coefficient sums
// (partial is then unused). The caller validates shapes and passes the plan
// (tiles per chunk, chunks per row, accumulator copies dividing 8, dynamic
// shared memory bytes) and a partial buffer of B * chunks * K * 4(n-1)
// elements. Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for a plan the kernel does not take.
extern "C" int ppoly_eval_backward_f64(
        const void* x, const void* coeffs, const void* q, const void* g,
        void* dq, void* dcoeffs, void* partial, int n, int K, long long B,
        long long M, int per_row_coeffs, int clamp, int tiles, int chunks,
        int copies, int smem, void* stream) {
    return launch_bwd<double>(x, coeffs, q, g, dq, dcoeffs, partial, n, K, B,
                              M, per_row_coeffs, clamp, tiles, chunks, copies,
                              smem, stream);
}

extern "C" int ppoly_eval_backward_f32(
        const void* x, const void* coeffs, const void* q, const void* g,
        void* dq, void* dcoeffs, void* partial, int n, int K, long long B,
        long long M, int per_row_coeffs, int clamp, int tiles, int chunks,
        int copies, int smem, void* stream) {
    return launch_bwd<float>(x, coeffs, q, g, dq, dcoeffs, partial, n, K, B,
                             M, per_row_coeffs, clamp, tiles, chunks, copies,
                             smem, stream);
}

// The second order (one call launches the chunk kernel and, when dcoeffs is
// wanted, the reduce). u, V null: no such cotangent; dq, dg, dcoeffs null:
// not wanted (dcoeffs needs u and a partial buffer of B * chunks * K *
// 4(n-1) elements). The caller validates shapes and passes the backward's
// plan for the same call, with dynamic shared memory for V when it is
// given. Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for a plan the kernel does not take.
extern "C" int ppoly_eval_second_order_f64(
        const void* x, const void* coeffs, const void* q, const void* g,
        const void* u, const void* V, void* dq, void* dg, void* dcoeffs,
        void* partial, int n, int K, long long B, long long M,
        int per_row_coeffs, int clamp, int tiles, int chunks, int copies,
        int smem, void* stream) {
    return launch_2nd<double>(x, coeffs, q, g, u, V, dq, dg, dcoeffs, partial,
                              n, K, B, M, per_row_coeffs, clamp, tiles,
                              chunks, copies, smem, stream);
}

extern "C" int ppoly_eval_second_order_f32(
        const void* x, const void* coeffs, const void* q, const void* g,
        const void* u, const void* V, void* dq, void* dg, void* dcoeffs,
        void* partial, int n, int K, long long B, long long M,
        int per_row_coeffs, int clamp, int tiles, int chunks, int copies,
        int smem, void* stream) {
    return launch_2nd<float>(x, coeffs, q, g, u, V, dq, dg, dcoeffs, partial,
                             n, K, B, M, per_row_coeffs, clamp, tiles, chunks,
                             copies, smem, stream);
}

// What the backward's plan needs of this kernel, in g[0..2]: BWD_THREADS,
// its warps, and the resident blocks per SM that the chunking aims to fill.
extern "C" int ppoly_eval_backward_geometry(int* g) {
    g[0] = BWD_THREADS;
    g[1] = BWD_WARPS;
    g[2] = BWD_BLOCKS_PER_SM;
    return 0;
}

// What the wrapper's launch plan needs of the card and of this kernel, in
// g[0..5]: the device's SM count, shared memory per SM and shared memory
// reserved per resident block (bytes), THREADS, and the resident blocks per
// SM with one and with two vectors per thread. Returns a CUDA error code.
extern "C" int ppoly_eval_geometry(int device, int* g) {
    const cudaDeviceAttr attrs[3] = {
        cudaDevAttrMultiProcessorCount,
        cudaDevAttrMaxSharedMemoryPerMultiprocessor,
        cudaDevAttrReservedSharedMemoryPerBlock};
    for (int i = 0; i < 3; ++i) {
        const cudaError_t err = cudaDeviceGetAttribute(g + i, attrs[i], device);
        if (err != cudaSuccess) return (int)err;
    }
    g[3] = THREADS;
    g[4] = BLOCKS_PER_SM_1;
    g[5] = BLOCKS_PER_SM_2;
    return 0;
}
