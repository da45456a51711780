"""Chebyshev series by Clenshaw's recurrence: the CUDA kernels' wrappers,
their plain versions, and the gradient.

`chebyshev_eval_cuda` launches `csrc/chebyshev_eval.cu`'s evaluation,
written for Hopper where the JAX package had no Pallas kernel (XLA fused its
`chebyshev_eval`, `victor_tpu/ops/splines.py:494-502`);
`chebyshev_eval_plain` is that recurrence in plain PyTorch, step for step.
The kernel takes up to two series over one query set,

    series   ((coef (B, K), a (B,), b (B,)), ...)   S <= MAX_SERIES series,
                                                     one K <= MAX_TERMS
    q        (B, M)                                  shared by the series

and returns one (B, M) tensor per series, each equal bit for bit to the
plain recurrence's for every input, NaN and out-of-range queries included
(the source's note says how).

`ChebyshevEval` is the evaluation with its gradient, by device: forward the
kernel or the plain recurrence, backward composed of

* the derivative's series: d out / d u = sum_k c_k T_k'(u) is itself a
  Chebyshev series, whose coefficients are a fixed linear map of coef
  (`derivative_coefficients`), evaluated by `ChebyshevEval` again;
* the chain through u = clip((2q - (a + b)) / (b - a), -1, 1), elementwise,
  with JAX's derivative of the clip (1 inside, 0.5 at either bound, 0
  outside and at NaN, as `ops.special.clip`);
* d out / d c_k = T_k(u), so the coefficients' gradient is the reduction
  sum_m g T_k(u) (`_ChebyshevTranspose`: `chebyshev_transpose_cuda` or
  `chebyshev_transpose_plain`), whose own gradient is again an evaluation.

Every piece is differentiable in turn, so a backward that records a graph
(a Hessian) is differentiated through the same kernels. The values equal
the plain recurrence's autograd up to rounding, not bit for bit: its
adjoint runs the recurrence backwards and sums in another order.
`ops.splines.chebyshev_eval_multi` calls the kernel directly for CUDA
tensors with no gradient recorded, `ChebyshevEval` for CUDA tensors under a
recorded gradient, and the plain recurrence for CPU tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from ..utils.profiling import count

MAX_SERIES = 2            # instantiated in csrc/chebyshev_eval.cu
MAX_TERMS = 128           # shared memory holds S x MAX_TERMS coefficients
THREADS = 256             # must match csrc/chebyshev_eval.cu
PAIRS_PER_THREAD = 2      # pairs of queries a thread takes in a full grid
POINTS = 4                # the transpose's queries per thread per pass
PASSES = 4                # the transpose's passes per block in a full grid
_GRID_LIMIT = 2 ** 31 - 1
_VECTOR = {torch.float64: 16, torch.float32: 8}   # bytes of a pair
_PTRS = ctypes.c_void_p * MAX_SERIES
_ARGTYPES = [_PTRS] * 4 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_longlong, ctypes.c_longlong,
                           ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
_T_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_longlong,
                                       ctypes.c_longlong, ctypes.c_longlong,
                                       ctypes.c_void_p]
_ENTRIES: dict = {}       # (kind, dtype) -> ctypes function
_DERIVATIVE: dict = {}    # (K, dtype, device) -> (K, K) matrix


def _check_common(tensors, q, what):
    if q.dtype not in _VECTOR or any(t.dtype != q.dtype for t in tensors):
        raise TypeError(f'{what} takes float32 or float64, one dtype for '
                        f'all; got {[str(t.dtype) for t in tensors]}')
    if q.ndim != 2:
        raise ValueError(f'q must be (B, M); got {tuple(q.shape)}')
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f'{what}: every tensor must be contiguous')


def _check_device(tensors, what):
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f'{what} records no gradient: use ChebyshevEval '
                           'or ops.splines.chebyshev_eval_multi')
    dev = tensors[-1].device
    if not (dev.type == 'cuda' and all(t.device == dev for t in tensors)):
        raise ValueError(f'{what} needs every tensor on one CUDA device; got '
                         f'{[str(t.device) for t in tensors]}')


def check_args(series, q) -> None:
    """Raise on what the evaluation kernel does not take: 1 <= S <=
    MAX_SERIES series (coef (B, K), a (B,), b (B,)) of one K, 1 <= K <=
    MAX_TERMS; q (B, M); float32 or float64, one dtype for all; every
    tensor contiguous."""
    series = list(series)
    if not 1 <= len(series) <= MAX_SERIES:
        raise ValueError(f'the kernel takes 1..{MAX_SERIES} series; got '
                         f'{len(series)}')
    flat = [t for s in series for t in s]
    _check_common(flat + [q], q, 'chebyshev_eval')
    B = q.shape[0]
    K = series[0][0].shape[-1]
    for coef, a, b in series:
        if coef.shape != (B, K):
            raise ValueError(f'coef must be ({B}, K), one K for every series;'
                             f' got {[tuple(s[0].shape) for s in series]}')
        if a.shape != (B,) or b.shape != (B,):
            raise ValueError(f'a and b must be ({B},); got {tuple(a.shape)} '
                             f'and {tuple(b.shape)}')
    if not 1 <= K <= MAX_TERMS:
        raise ValueError(f'the kernel takes 1..{MAX_TERMS} terms; got K = {K}')


def _entry(kind: str, dtype: torch.dtype):
    if (kind, dtype) not in _ENTRIES:
        lib = _build.load('chebyshev_eval')
        fn = getattr(lib, f'chebyshev_{kind}_'
                          f'{"f64" if dtype == torch.float64 else "f32"}')
        fn.argtypes = _ARGTYPES if kind == 'eval' else _T_ARGTYPES
        fn.restype = ctypes.c_int
        _ENTRIES[kind, dtype] = fn
    return _ENTRIES[kind, dtype]


def _launch(fn, args, index):
    if index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f'chebyshev_eval kernel launch failed: CUDA error '
                           f'{err}')


def blocks_per_row(B: int, M: int) -> int:
    """The evaluation's blocks that share one row: enough for
    PAIRS_PER_THREAD pairs of queries per thread, within the grid's limit
    of 2**31 - 1 blocks."""
    pairs = (M + 1) // 2
    return max(1, min(-(-pairs // (THREADS * PAIRS_PER_THREAD)),
                      _GRID_LIMIT // max(B, 1)))


def transpose_blocks_per_row(B: int, M: int) -> int:
    """The transpose's blocks per row: PASSES passes of POINTS queries per
    thread each, within the grid's limit."""
    return max(1, min(-(-M // (THREADS * POINTS * PASSES)),
                      _GRID_LIMIT // max(B, 1)))


def chebyshev_eval_cuda(series, q: torch.Tensor) -> tuple:
    """Launch the evaluation kernel on the current stream (no
    synchronisation): a tuple of one (B, M) tensor per series. Counts
    `chebyshev.launches` on q's device (`utils.profiling`)."""
    series = [tuple(s) for s in series]
    check_args(series, q)
    _check_device([t for s in series for t in s] + [q], 'chebyshev_eval_cuda')
    B, M = q.shape
    S, K = len(series), series[0][0].shape[1]
    outs = tuple(torch.empty_like(q) for _ in range(S))
    if q.numel() == 0:
        return outs
    vec = int(M % 2 == 0 and not any(t.data_ptr() % _VECTOR[q.dtype]
                                     for t in (q,) + outs))

    def ptrs(ts):
        return _PTRS(*[t.data_ptr() for t in ts])

    index = q.device.index
    _launch(_entry('eval', q.dtype),
            (ptrs([s[0] for s in series]), ptrs([s[1] for s in series]),
             ptrs([s[2] for s in series]), ptrs(outs), q.data_ptr(), S, K, B,
             M, blocks_per_row(B, M), vec), index)
    count('chebyshev.launches', 1, index)
    return outs


def chebyshev_transpose_cuda(g, a, b, q, K: int) -> torch.Tensor:
    """Launch the transpose kernel: (B, K) with entry k the sum over each
    row's queries of g T_k(u). g and q (B, M), a and b (B,). Counts
    `chebyshev.transpose_launches`."""
    _check_common((g, a, b, q), q, 'chebyshev_transpose')
    B, M = q.shape
    if g.shape != (B, M) or a.shape != (B,) or b.shape != (B,):
        raise ValueError(f'g must be ({B}, {M}) and a, b ({B},); got '
                         f'{tuple(g.shape)}, {tuple(a.shape)}, '
                         f'{tuple(b.shape)}')
    if not 1 <= K <= MAX_TERMS:
        raise ValueError(f'the kernel takes 1..{MAX_TERMS} terms; got K = {K}')
    _check_device((g, a, b, q), 'chebyshev_transpose_cuda')
    if q.numel() == 0:
        return q.new_zeros((B, K))
    per_row = transpose_blocks_per_row(B, M)
    partial = torch.empty((B, per_row, K), dtype=q.dtype, device=q.device)
    index = q.device.index
    _launch(_entry('transpose', q.dtype),
            (g.data_ptr(), a.data_ptr(), b.data_ptr(), q.data_ptr(),
             partial.data_ptr(), K, B, M, per_row), index)
    count('chebyshev.transpose_launches', 1, index)
    return partial.sum(1)


def chebyshev_eval_plain(coef: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                         q: torch.Tensor) -> torch.Tensor:
    """One series per row in plain PyTorch: coef (B, K), a and b (B,), q
    (B, ...) -> q's shape. The recurrence is the JAX package's, step for
    step; autograd runs through its operations (`ops.special.clip` gives
    JAX's derivative). A CUDA q counts `chebyshev.plain_cuda`: the port
    sends only CPU tensors here."""
    from ..ops.special import clip
    if q.is_cuda:
        count('chebyshev.plain_cuda', 1, q.device)
    shape = (-1,) + (1,) * (q.ndim - 1)
    a, b = a.reshape(shape), b.reshape(shape)
    u = clip((2.0 * q - (a + b)) / (b - a), -1.0, 1.0)
    u2 = 2.0 * u          # `2.0 * u * b1` is (2.0 * u) * b1: hoisted, same bits
    b1 = torch.zeros_like(u)
    b2 = torch.zeros_like(u)
    for k in range(coef.shape[1] - 1, 0, -1):
        b1, b2 = u2 * b1 - b2 + coef[:, k].reshape(shape), b1
    return u * b1 - b2 + coef[:, 0].reshape(shape)


def chebyshev_transpose_plain(g, a, b, q, K: int) -> torch.Tensor:
    """`chebyshev_transpose_cuda` in plain PyTorch: (B, K), entry k the sum
    over each row's queries of g T_k(u), T_k by the three-term recurrence.
    A CUDA q counts `chebyshev.plain_cuda`."""
    from ..ops.special import clip
    if q.is_cuda:
        count('chebyshev.plain_cuda', 1, q.device)
    u = clip((2.0 * q - (a + b)[:, None]) / (b - a)[:, None], -1.0, 1.0)
    t0, t1 = torch.ones_like(u), u
    sums = [g.sum(-1), (g * u).sum(-1)]
    for _ in range(2, K):
        t0, t1 = t1, 2.0 * u * t1 - t0
        sums.append((g * t1).sum(-1))
    return torch.stack(sums[:K], -1)


def derivative_coefficients(coef: torch.Tensor) -> torch.Tensor:
    """The coefficients (B, K) of d/du sum_k coef_k T_k(u), the last one
    zero: d_j = sum over k > j with k - j odd of 2 k coef_k, d_0 halved. A
    fixed matrix, so the map is linear and differentiable; coef_0 does not
    enter it, not even times 0 (a NaN row keeps its gradient to coef_0)."""
    K = coef.shape[-1]
    key = (K, coef.dtype, coef.device)
    if key not in _DERIVATIVE:
        k = np.arange(K)
        d = np.where((k[None, :] > k[:, None])
                     & ((k[None, :] - k[:, None]) % 2 == 1),
                     2.0 * k[None, :], 0.0)
        d[0] *= 0.5
        _DERIVATIVE[key] = torch.as_tensor(d, dtype=coef.dtype,
                                           device=coef.device)
    return coef[:, 1:] @ _DERIVATIVE[key][:, 1:].T


def _through_u(gu, a, b, q, need):
    """d/dq, d/da and d/db (None where `need` says no) of a loss whose
    derivative to u = clip((2q - (a + b)) / (b - a), -1, 1) is gu (B, M):
    the clip's JAX derivative, then the quotient's. Differentiable in gu,
    a, b and q."""
    w = (b - a)[:, None]
    t = (2.0 * q - (a + b)[:, None]) / w
    with torch.no_grad():
        r = t.abs()
        slope = (r < 1.0).to(t.dtype) + 0.5 * (r == 1.0).to(t.dtype)
    gtw = gu * slope / w
    dq = 2.0 * gtw if need[0] else None
    da = (gtw * (t - 1.0)).sum(-1) if need[1] else None
    db = -(gtw * (t + 1.0)).sum(-1) if need[2] else None
    return dq, da, db


def _add(x, y):
    return y if x is None else x if y is None else x + y


class ChebyshevEval(torch.autograd.Function):
    """`ChebyshevEval.apply(q, coef_0, a_0, b_0, coef_1, a_1, b_1, ...)`:
    the series' values over q (B, M), one (B, M) tensor each, with their
    gradient to every input (module docstring). Forward
    `chebyshev_eval_cuda` or `chebyshev_eval_plain`, by device."""

    @staticmethod
    def forward(ctx, q, *flat):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, *flat)
        series = [flat[i:i + 3] for i in range(0, len(flat), 3)]
        if q.is_cuda:
            return chebyshev_eval_cuda(
                [tuple(t.contiguous() for t in s) for s in series],
                q.contiguous())
        return tuple(chebyshev_eval_plain(c, a, b, q) for c, a, b in series)

    @staticmethod
    def backward(ctx, *grads):
        q, *flat = ctx.saved_tensors
        need = ctx.needs_input_grad
        out = [None] * (1 + len(flat))
        live = [s for s, g in enumerate(grads) if g is not None]
        chained = [s for s in live if any(need[i] for i in
                                          (0, 2 + 3 * s, 3 + 3 * s))]
        slopes = {}
        if chained:
            args = [t for s in chained for t in (
                derivative_coefficients(flat[3 * s]), flat[3 * s + 1],
                flat[3 * s + 2])]
            slopes = dict(zip(chained, ChebyshevEval.apply(q, *args)))
        for s in live:
            coef, a, b = flat[3 * s:3 * s + 3]
            if need[1 + 3 * s]:
                out[1 + 3 * s] = _ChebyshevTranspose.apply(
                    grads[s], a, b, q, coef.shape[1])
            if s in slopes:
                dq, da, db = _through_u(
                    grads[s] * slopes[s], a, b, q,
                    (need[0], need[2 + 3 * s], need[3 + 3 * s]))
                out[0] = _add(out[0], dq)
                out[2 + 3 * s], out[3 + 3 * s] = da, db
        return tuple(out)


class _ChebyshevTranspose(torch.autograd.Function):
    """`_ChebyshevTranspose.apply(g, a, b, q, K)`: (B, K), entry k the sum
    over each row's queries of g T_k(u) (the coefficients' gradient of
    `ChebyshevEval`). Its gradient h (B, K) gives d/dg = sum_k h_k T_k(u)
    and d/du = g sum_k h_k T_k'(u): two series over q, one launch."""

    @staticmethod
    def forward(ctx, g, a, b, q, K):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(g, a, b, q)
        if q.is_cuda:
            return chebyshev_transpose_cuda(g.contiguous(), a.contiguous(),
                                            b.contiguous(), q.contiguous(), K)
        return chebyshev_transpose_plain(g, a, b, q, K)

    @staticmethod
    def backward(ctx, h):
        g, a, b, q = ctx.saved_tensors
        need = ctx.needs_input_grad
        if h is None:
            return None, None, None, None, None
        chain = any(need[1:4])
        args = ((h, a, b) if need[0] else ()) + (
            (derivative_coefficients(h), a, b) if chain else ())
        if not args:
            return None, None, None, None, None
        vals = list(ChebyshevEval.apply(q, *args))
        dg = vals.pop(0) if need[0] else None
        da = db = dq = None
        if chain:
            dq, da, db = _through_u(g * vals.pop(0), a, b, q,
                                    (need[3], need[1], need[2]))
        return dg, da, db, dq, None
