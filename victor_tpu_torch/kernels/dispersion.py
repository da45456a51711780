"""The dispersion model's final stage: the CUDA kernel's wrapper and its plain
version.

`dispersion_final_cuda` launches `csrc/dispersion_final.cu`, the Hopper port
of `victor_tpu/ops/dispersion_pallas.py::dispersion_final_fused`;
`dispersion_final_plain` is the same function in plain PyTorch, with the
exact path's op order (`models/ccf_theory.py`). Both take

    x         (n,)            velocity-spline knots, sorted
    c_vr      (Bc, n-1, 4)    v_r spline coefficients, Bc in {1, B}
    c_dvr     (Bc, n-1, 4)    dv_r/dr spline coefficients
    r_par     (B, n_v, q)     line-of-sight coordinate after the interior
                              Picard iterations
    A         (B, n_v, q)     fixed-point constant s_par - v_par / (aH)
    s_perp    (B, q)          transverse coordinate
    iaH       (B,)            1/(aH), AP-corrected
    resc_vel  (B,)            template rescaling of the velocity splines

and return (r_par_final, rr, mu_r, jacobian), each (B, n_v, q).
`ops.splines.dispersion_final` picks between them by device. There is no
autograd: the TPU kernel had no VJP either.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ..utils.profiling import count
from .ppoly import ppoly_eval_plain

MAX_KNOTS = 512           # shared memory: 8n + 64(n-1) bytes in f64, < 48 KB
THREADS = 256             # must match csrc/dispersion_final.cu
POINTS_PER_THREAD = 4     # work per thread when the grid is large enough
_GRID_LIMIT = 2 ** 31 - 1

_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int, ctypes.c_longlong,
                                      ctypes.c_longlong, ctypes.c_longlong,
                                      ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_void_p]


def check_args(x, c_vr, c_dvr, r_par, A, s_perp, iaH, resc_vel) -> None:
    """Raise on dtypes or shapes that neither version takes."""
    args = (x, c_vr, c_dvr, r_par, A, s_perp, iaH, resc_vel)
    if r_par.dtype not in (torch.float32, torch.float64) or \
            any(t.dtype != r_par.dtype for t in args):
        raise TypeError('dispersion_final takes float32 or float64, one dtype '
                        f'for all; got {[str(t.dtype) for t in args]}')
    n = x.shape[0] if x.ndim == 1 else -1
    if not 2 <= n <= MAX_KNOTS:
        raise ValueError(f'x must be 1D with 2..{MAX_KNOTS} knots; got shape '
                         f'{tuple(x.shape)}')
    if r_par.ndim != 3 or A.shape != r_par.shape:
        raise ValueError('r_par and A must be one (B, n_v, q) shape; got '
                         f'{tuple(r_par.shape)} and {tuple(A.shape)}')
    B, _, q = r_par.shape
    if s_perp.shape != (B, q):
        raise ValueError(f's_perp must be ({B}, {q}); got {tuple(s_perp.shape)}')
    if iaH.shape != (B,) or resc_vel.shape != (B,):
        raise ValueError(f'iaH and resc_vel must be ({B},); got '
                         f'{tuple(iaH.shape)} and {tuple(resc_vel.shape)}')
    for name, c in (('c_vr', c_vr), ('c_dvr', c_dvr)):
        if c.ndim != 3 or c.shape[1:] != (n - 1, 4) or c.shape[0] not in (1, B):
            raise ValueError(f'{name} must be (1 or {B}, {n - 1}, 4); got '
                             f'{tuple(c.shape)}')
    if c_vr.shape[0] != c_dvr.shape[0]:
        raise ValueError('c_vr and c_dvr must both be shared or both per row')


def _entry(dtype: torch.dtype):
    lib = _build.load('dispersion_final')
    fn = lib.dispersion_final_f64 if dtype == torch.float64 \
        else lib.dispersion_final_f32
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def dispersion_final_cuda(x, c_vr, c_dvr, r_par, A, s_perp, iaH, resc_vel):
    """Launch the CUDA kernel on the current stream (no synchronisation).
    Counts `dispersion.launches` on the inputs' device
    (`utils.profiling`)."""
    args = (x, c_vr, c_dvr, r_par, A, s_perp, iaH, resc_vel)
    names = ('x', 'c_vr', 'c_dvr', 'r_par', 'A', 's_perp', 'iaH', 'resc_vel')
    if not all(t.is_cuda for t in args):
        raise ValueError('dispersion_final_cuda needs CUDA tensors; got devices '
                         f'{[str(t.device) for t in args]}')
    if any(t.device != r_par.device for t in args):
        raise ValueError('dispersion_final_cuda: inputs lie on different '
                         f'devices {[str(t.device) for t in args]}')
    check_args(*args)
    if any(t.requires_grad for t in args):
        raise RuntimeError('dispersion_final_cuda has no backward: the kernel '
                           'is forward only, as the TPU kernel was')
    for name, t in zip(names, args):
        if not t.is_contiguous():
            raise ValueError(f'dispersion_final_cuda: {name} must be contiguous')
    B, n_v, q = r_par.shape
    if B > _GRID_LIMIT:
        raise ValueError(f'batch of {B} rows exceeds the grid limit')
    outs = tuple(torch.empty_like(r_par) for _ in range(4))
    M = n_v * q
    if outs[0].numel() == 0:
        return outs
    blocks_per_row = min(-(-M // (THREADS * POINTS_PER_THREAD)),
                         max(1, _GRID_LIMIT // B))
    fn = _entry(r_par.dtype)
    with torch.cuda.device(r_par.device):
        err = fn(*(t.data_ptr() for t in args + outs), x.shape[0], B, q, M,
                 blocks_per_row, int(c_vr.shape[0] > 1),
                 torch.cuda.current_stream(r_par.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'dispersion_final kernel launch failed: CUDA error '
                           f'{err}')
    count('dispersion.launches', 1, r_par.device)
    return outs


def dispersion_final_plain(x, c_vr, c_dvr, r_par, A, s_perp, iaH, resc_vel):
    """The same function in plain PyTorch: three clamped `ppoly_eval_plain`
    lookups (v_r at rr_prev, then v_r and dv_r at rr) and the exact path's
    elementwise order (victor_tpu/models/ccf_theory.py:330-357)."""
    B = r_par.shape[0]

    def b3(v):
        return v[:, None, None]

    def lookup(c, qq):
        return ppoly_eval_plain(x, c, qq.reshape(B, -1)).reshape(qq.shape)

    sp2 = s_perp[:, None, :] ** 2
    rr_prev = torch.sqrt(sp2 + r_par ** 2)
    vr_prev = lookup(c_vr, rr_prev / b3(resc_vel))
    r_par_f = A / (1.0 + b3(iaH) * vr_prev / rr_prev)
    rr = torch.sqrt(sp2 + r_par_f ** 2)
    mu_r = r_par_f / rr
    q2 = rr / b3(resc_vel)
    vr_rr = lookup(c_vr, q2)
    dvr_rr = lookup(c_dvr, q2) / b3(resc_vel)
    jac = 1.0 / (1.0 + vr_rr * b3(iaH) / rr
                 + b3(iaH) * mu_r ** 2 * (dvr_rr - vr_rr / rr))
    return r_par_f, rr, mu_r, jac
