"""Piecewise-cubic evaluation: the CUDA kernel's wrapper and its plain version.

`ppoly_eval_cuda` launches `csrc/ppoly_eval.cu`, the Hopper port of
`victor_tpu/ops/splines.py::ppoly_eval_pallas` with the channel axes of the
JAX masksum; `ppoly_eval_plain` is the same function in plain PyTorch
(searchsorted and a gather, as the JAX 'gather' strategy). Both take

    x      (n,)                       sorted knots
    coeffs (Bc, n-1, 4)               one table per row, Bc in {1, B}, or
           (Bc, K, n-1, 4)            K <= 4 tables (channels) per row
    q      (B, M)                     queries

and return (B, M) for 3D coefficients, (B, K, M) for 4D ones: one interval
search per query serves every channel. `ops.splines.ppoly_eval` and
`ops.splines.ppoly_eval_multi` pick between them by device. There is no
autograd: the TPU kernel had no VJP and this path is forward only.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: number of kernel launches since the count was last reset
LAUNCHES = 0
#: of those, launches with more than one channel
LAUNCHES_MULTI = 0

MAX_KNOTS = 1024          # with K = 1: 8n + 32(n-1) bytes in f64, < 48 KB
MAX_CHANNELS = 4          # instantiated in csrc/ppoly_eval.cu
SMEM_LIMIT = 48 * 1024    # dynamic shared memory a block takes without opt-in
THREADS = 256             # must match csrc/ppoly_eval.cu
POINTS_PER_THREAD = 4     # work per thread when the grid is large enough
_GRID_LIMIT = 2 ** 31 - 1

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_longlong, ctypes.c_longlong,
                                     ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]


def _entry(dtype: torch.dtype):
    lib = _build.load('ppoly_eval')
    fn = lib.ppoly_eval_f64 if dtype == torch.float64 else lib.ppoly_eval_f32
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _smem_bytes(n: int, K: int, dtype: torch.dtype) -> int:
    """Shared memory one block stages: the knots and K coefficient tables."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return itemsize * (n + 4 * K * (n - 1))


def _check(x, coeffs, q):
    if not (x.is_cuda and coeffs.is_cuda and q.is_cuda):
        raise ValueError('ppoly_eval_cuda needs CUDA tensors; got devices '
                         f'{x.device}, {coeffs.device}, {q.device}')
    if not (x.device == coeffs.device == q.device):
        raise ValueError('ppoly_eval_cuda: x, coeffs and q lie on different '
                         f'devices ({x.device}, {coeffs.device}, {q.device})')
    if q.dtype not in (torch.float32, torch.float64) or \
            not (x.dtype == coeffs.dtype == q.dtype):
        raise TypeError('ppoly_eval_cuda takes float32 or float64, one dtype '
                        f'for all; got {x.dtype}, {coeffs.dtype}, {q.dtype}')
    if x.requires_grad or coeffs.requires_grad or q.requires_grad:
        raise RuntimeError('ppoly_eval_cuda has no backward: the kernel is '
                           'forward only (gradients come with the HMC port)')
    n = x.shape[0] if x.ndim == 1 else -1
    if not 2 <= n <= MAX_KNOTS:
        raise ValueError(f'x must be 1D with 2..{MAX_KNOTS} knots; got shape '
                         f'{tuple(x.shape)}')
    if q.ndim != 2:
        raise ValueError(f'q must be (B, M); got shape {tuple(q.shape)}')
    B = q.shape[0]
    if coeffs.ndim not in (3, 4) or coeffs.shape[-2:] != (n - 1, 4) or \
            coeffs.shape[0] not in (1, B):
        raise ValueError(f'coeffs must be (1 or {B}, [K,] {n - 1}, 4); got '
                         f'{tuple(coeffs.shape)}')
    K = coeffs.shape[1] if coeffs.ndim == 4 else 1
    if not 1 <= K <= MAX_CHANNELS:
        raise ValueError(f'coeffs has {K} channels; the kernel takes 1..'
                         f'{MAX_CHANNELS}')
    if _smem_bytes(n, K, q.dtype) > SMEM_LIMIT:
        raise ValueError(f'{K} channels of {n} knots need '
                         f'{_smem_bytes(n, K, q.dtype)} bytes of shared memory; '
                         f'one block takes at most {SMEM_LIMIT}')
    if B > _GRID_LIMIT:
        raise ValueError(f'batch of {B} rows exceeds the grid limit')
    for name, t in (('x', x), ('coeffs', coeffs), ('q', q)):
        if not t.is_contiguous():
            raise ValueError(f'ppoly_eval_cuda: {name} must be contiguous')
    return K


def ppoly_eval_cuda(x: torch.Tensor, coeffs: torch.Tensor, q: torch.Tensor,
                    clamp: bool = True) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no synchronisation)."""
    global LAUNCHES, LAUNCHES_MULTI
    K = _check(x, coeffs, q)
    B, M = q.shape
    out = q.new_empty((B, K, M) if coeffs.ndim == 4 else (B, M))
    if out.numel() == 0:
        return out
    blocks_per_row = min(-(-M // (THREADS * POINTS_PER_THREAD)),
                         max(1, _GRID_LIMIT // B))
    fn = _entry(q.dtype)
    with torch.cuda.device(q.device):
        err = fn(x.data_ptr(), coeffs.data_ptr(), q.data_ptr(), out.data_ptr(),
                 x.shape[0], K, B, M, blocks_per_row,
                 int(coeffs.shape[0] > 1), int(clamp),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'ppoly_eval kernel launch failed: CUDA error {err}')
    LAUNCHES += 1
    LAUNCHES_MULTI += K > 1
    return out


def ppoly_eval_plain(x: torch.Tensor, coeffs: torch.Tensor, q: torch.Tensor,
                     clamp: bool = True) -> torch.Tensor:
    """The same function in plain PyTorch: `torch.clamp` (which keeps NaN),
    searchsorted(right) and a gather per coefficient, the kernel's Horner
    order and its `+ (qq - qq)` NaN term. With 4D coefficients the interval
    index is found once and every channel gathers with it, so each channel
    equals a 3D call on its own table bit for bit."""
    n = x.shape[0]
    qq = torch.clamp(q, x[0], x[-1]) if clamp else q
    idx = torch.clamp(torch.searchsorted(x, qq, right=True) - 1, 0, n - 2)
    t = qq - x[idx]
    if coeffs.ndim == 4:
        return torch.stack([_horner(coeffs[:, k], idx, t, qq)
                            for k in range(coeffs.shape[1])], 1)
    return _horner(coeffs, idx, t, qq)


def _horner(coeffs, idx, t, qq):
    """Horner's rule on (Bc, n-1, 4) coefficients at interval indices `idx`
    and offsets `t`, both (B, M)."""
    c = coeffs.expand(qq.shape[0], -1, -1)
    c0, c1, c2, c3 = (torch.gather(c[..., k], 1, idx) for k in range(4))
    return ((c3 * t + c2) * t + c1) * t + c0 + (qq - qq)
