// The dispersion model's final stage for Hopper (sm_90a).
//
// Replaces victor_tpu/ops/dispersion_pallas.py::dispersion_final_fused, the
// Pallas TPU kernel that runs the dispersion RSD model's exact final stage in
// one pass. It computes the same function, generalised to the batch:
//
//   x              (n,)             velocity-spline knots, sorted
//   c_vr, c_dvr    (Bc, n-1, 4)     v_r and dv_r/dr coefficients, Bc in {1, B}
//   r_par, A       (B, n_v, q)      coordinate after the interior Picard
//                                   iterations; fixed-point constant
//   s_perp         (B, q)           transverse coordinate
//   iaH, resc_vel  (B,)             1/(aH); velocity-template rescaling
//   outputs        (B, n_v, q) x 4  r_par_f, rr, mu_r, jac
//
// per element, with V(u) = clamped cubic of c_vr at u, D(u) that of c_dvr:
//
//   rr_prev = sqrt(s_perp^2 + r_par^2)
//   r_par_f = A / (1 + iaH * V(rr_prev / resc) / rr_prev)
//   rr      = sqrt(s_perp^2 + r_par_f^2),  mu_r = r_par_f / rr
//   v, d    = V(rr / resc), D(rr / resc) / resc   (one interval search)
//   jac     = 1 / (1 + v * iaH / rr + iaH * mu_r^2 * (d - v / rr))
//
// The op order is that of the exact path (victor_tpu/models/ccf_theory.py:
// 330-357) and of the plain version in kernels/dispersion.py; nvcc contracts
// multiply-adds into FMAs, which is the only difference (a few ulp, and an
// interval choice that may flip for a query within an ulp of a knot, where
// the cubic spline is continuous). Each lookup clamps its query with selects,
// not fmin/fmax (those return the non-NaN operand and would turn a NaN
// parameter into a finite chi^2), and adds `(qq - qq)`, so NaN stays NaN.
//
// Layout: one thread per (b, v, j) element. Each block serves one batch row:
// it stages x, c_vr[b] and c_dvr[b] in shared memory (about 2.2 KB in f64 at
// n = 31), then its threads stride over a slice of the row's n_v * q
// elements and read s_perp[b, j % q]. The first lookup has a binary search of
// its own; the two Jacobian lookups share one. Rows and slices share
// gridDim.x, and offsets are 64-bit. Nothing but the four outputs is written
// to device memory.
//
// Bound: bytes. In f64 each element reads r_par and A (16 B) and writes four
// outputs (32 B): 48 B x 9.6 M elements = 461 MB per call at a chunk of 64
// parameter points at BOSS size, at least 0.14 ms at the H100's 3.35 TB/s.
// Against that, two short binary searches, two sqrt and eight divisions per
// element. Nothing here is tuned yet.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__device__ __forceinline__ T clamp_keep_nan(T q, T lo, T hi) {
    q = (q < lo) ? lo : q;
    q = (q > hi) ? hi : q;
    return q;
}

// largest i in [0, n-2] with x[i] <= qq (i = 0 when none, or for NaN)
template <typename T>
__device__ __forceinline__ int interval(const T* sx, int n, T qq) {
    int lo = 0, hi = n - 2;
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (sx[mid] <= qq) lo = mid; else hi = mid - 1;
    }
    return lo;
}

template <typename T>
__device__ __forceinline__ T horner(const T* c, T t) {
    return ((c[3] * t + c[2]) * t + c[1]) * t + c[0];
}

template <typename T>
__global__ void dispersion_final_kernel(
        const T* __restrict__ x, const T* __restrict__ c_vr,
        const T* __restrict__ c_dvr, const T* __restrict__ r_par,
        const T* __restrict__ A, const T* __restrict__ s_perp,
        const T* __restrict__ iaH, const T* __restrict__ resc_vel,
        T* __restrict__ out_r_par, T* __restrict__ out_rr,
        T* __restrict__ out_mu, T* __restrict__ out_jac,
        int n, int64_t q, int64_t M, int64_t blocks_per_row,
        int per_row_coeffs) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* sx = reinterpret_cast<T*>(smem_raw);
    T* scv = sx + n;
    T* scd = scv + 4 * (n - 1);

    const int64_t row = blockIdx.x / blocks_per_row;
    const int64_t slice = blockIdx.x - row * blocks_per_row;
    const int64_t coff = per_row_coeffs ? row * (int64_t)(n - 1) * 4 : 0;

    for (int i = threadIdx.x; i < n; i += blockDim.x) sx[i] = x[i];
    for (int i = threadIdx.x; i < (n - 1) * 4; i += blockDim.x) {
        scv[i] = c_vr[coff + i];
        scd[i] = c_dvr[coff + i];
    }
    __syncthreads();

    const T x0 = sx[0];
    const T xn = sx[n - 1];
    const T iah = iaH[row];
    const T resc = resc_vel[row];
    const T* sp_row = s_perp + row * q;
    const int64_t base = row * M;
    const int64_t stride = blocks_per_row * (int64_t)blockDim.x;
    for (int64_t j = slice * (int64_t)blockDim.x + threadIdx.x; j < M;
         j += stride) {
        const T sp = sp_row[j % q];
        const T rp = r_par[base + j];
        const T a = A[base + j];

        // exact final Picard update
        const T rr_prev = sqrt(sp * sp + rp * rp);
        const T q1 = clamp_keep_nan(rr_prev / resc, x0, xn);
        const int i1 = interval(sx, n, q1);
        const T vr_prev = horner(scv + 4 * i1, q1 - sx[i1]) + (q1 - q1);
        const T rpf = a / (T(1) + iah * vr_prev / rr_prev);

        const T rr = sqrt(sp * sp + rpf * rpf);
        const T mu = rpf / rr;

        // the Jacobian's v_r and dv_r/dr share one interval search
        const T q2 = clamp_keep_nan(rr / resc, x0, xn);
        const int i2 = interval(sx, n, q2);
        const T t2 = q2 - sx[i2];
        const T vr = horner(scv + 4 * i2, t2) + (q2 - q2);
        const T dvr = (horner(scd + 4 * i2, t2) + (q2 - q2)) / resc;
        const T jac = T(1) / (T(1) + vr * iah / rr
                              + iah * (mu * mu) * (dvr - vr / rr));

        out_r_par[base + j] = rpf;
        out_rr[base + j] = rr;
        out_mu[base + j] = mu;
        out_jac[base + j] = jac;
    }
}

template <typename T>
int launch(const void* x, const void* c_vr, const void* c_dvr,
           const void* r_par, const void* A, const void* s_perp,
           const void* iaH, const void* resc_vel, void* out_r_par,
           void* out_rr, void* out_mu, void* out_jac, int n, long long B,
           long long q, long long M, long long blocks_per_row,
           int per_row_coeffs, void* stream) {
    const int threads = 256;
    const size_t smem = sizeof(T) * ((size_t)n + 8 * (size_t)(n - 1));
    const dim3 grid((unsigned int)(B * blocks_per_row));
    dispersion_final_kernel<T><<<grid, threads, smem, (cudaStream_t)stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(c_vr),
        static_cast<const T*>(c_dvr), static_cast<const T*>(r_par),
        static_cast<const T*>(A), static_cast<const T*>(s_perp),
        static_cast<const T*>(iaH), static_cast<const T*>(resc_vel),
        static_cast<T*>(out_r_par), static_cast<T*>(out_rr),
        static_cast<T*>(out_mu), static_cast<T*>(out_jac), n, (int64_t)q,
        (int64_t)M, (int64_t)blocks_per_row, per_row_coeffs);
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes. The caller validates shapes and sizes;
// the return value is cudaGetLastError() right after the launch.
#define DISPERSION_FINAL_ENTRY(NAME, T)                                       \
    extern "C" int NAME(const void* x, const void* c_vr, const void* c_dvr,  \
                        const void* r_par, const void* A,                     \
                        const void* s_perp, const void* iaH,                  \
                        const void* resc_vel, void* out_r_par, void* out_rr,  \
                        void* out_mu, void* out_jac, int n, long long B,      \
                        long long q, long long M, long long blocks_per_row,   \
                        int per_row_coeffs, void* stream) {                   \
        return launch<T>(x, c_vr, c_dvr, r_par, A, s_perp, iaH, resc_vel,     \
                         out_r_par, out_rr, out_mu, out_jac, n, B, q, M,      \
                         blocks_per_row, per_row_coeffs, stream);             \
    }

DISPERSION_FINAL_ENTRY(dispersion_final_f64, double)
DISPERSION_FINAL_ENTRY(dispersion_final_f32, float)
