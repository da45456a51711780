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
`ops.splines.ppoly_eval_multi` pick between them by device.

The gradient (which the TPU kernel lacked: JAX differentiated its plain
version) is `PpolyEval`, a `torch.autograd.Function` whose backward is the
hand-written kernel of the same source (`ppoly_eval_backward_cuda`) on CUDA
tensors and `ppoly_eval_backward_plain` on CPU tensors: dq, and dcoeffs
summed over each table's queries in a fixed order. x takes no gradient.

A backward that records a graph (create_graph=True, as a Hessian needs)
goes through `_PpolyEvalBackward`, whose own backward is
`ppoly_eval_second_order`: on CUDA tensors the fused second-order kernel of
the same source (`ppoly_eval_second_order_cuda`, one launch per call, two
with d/dcoeffs), on CPU tensors the composition of the plain versions on
tables derived elementwise (`ppoly_eval_second_order_composed`, whose
docstring has the algebra). A third order raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import _build
from ..utils.profiling import count, count_bytes

MAX_KNOTS = 1024          # with K = 1: 40,936 bytes of table in f64, < 48 KB
MAX_CHANNELS = 4          # instantiated in csrc/ppoly_eval.cu
SMEM_LIMIT = 48 * 1024    # dynamic shared memory a block takes without opt-in
VECTOR_BYTES = 16         # one double2 / float4 load or store
TWO_LOADS_WAVES = 4       # two vectors per thread from this many waves of work

_ARGTYPES = ([ctypes.c_void_p] * 4 +
             [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong]
             + [ctypes.c_int] * 6 + [ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 7 +
                 [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_longlong] + [ctypes.c_int] * 6 + [ctypes.c_void_p])
BWD_SMEM_BUDGET = 48 * 1024   # the backward halves its accumulator copies
                              # until table + copies fit in this
_2ND_ARGTYPES = ([ctypes.c_void_p] * 10 +
                 [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_longlong] + [ctypes.c_int] * 6 + [ctypes.c_void_p])
_DTYPES = {torch.float32: 4, torch.float64: 8}     # dtype -> itemsize
_ENTRIES: dict = {}       # (dtype, kind) -> ctypes function
_GEOMETRY: dict = {}      # device index -> Geometry


class Geometry(NamedTuple):
    """What the launch plan needs of the card and of the kernel, as
    `ppoly_eval_geometry` in csrc/ppoly_eval.cu reports them: the SM count,
    shared memory per SM and reserved per resident block (bytes), threads
    per block, and resident blocks per SM with one and with two vectors per
    thread (the kernel's launch bounds)."""
    sms: int
    smem_per_sm: int
    smem_reserved: int
    threads: int
    blocks_per_sm: tuple


class LaunchPlan(NamedTuple):
    """How one call is launched: the vector width in elements (1: scalar
    loads and stores); vectors per thread per tile (1 or 2); the grid;
    dynamic shared memory bytes."""
    vec: int
    loads: int
    grid: int
    smem: int


class BackwardPlan(NamedTuple):
    """How one backward call is launched: tiles of `threads` queries per
    chunk (one block each), chunks per row, copies of the coefficient
    accumulators in shared memory (dividing the warps), dynamic shared
    memory bytes."""
    tiles: int
    chunks: int
    copies: int
    smem: int


_KINDS = {'forward': ('ppoly_eval_', _ARGTYPES),
          'backward': ('ppoly_eval_backward_', _BWD_ARGTYPES),
          'second_order': ('ppoly_eval_second_order_', _2ND_ARGTYPES)}


def _entry(dtype: torch.dtype, kind: str = 'forward'):
    fn = _ENTRIES.get((dtype, kind))
    if fn is None:
        prefix, argtypes = _KINDS[kind]
        fn = getattr(_build.load('ppoly_eval'),
                     prefix + ('f64' if dtype == torch.float64 else 'f32'))
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _ENTRIES[(dtype, kind)] = fn
    return fn


def _geometry(index: int) -> Geometry:
    geo = _GEOMETRY.get(index)
    if geo is None:
        g = (ctypes.c_int * 6)()
        err = _build.load('ppoly_eval').ppoly_eval_geometry(index, g)
        if err != 0:
            raise RuntimeError(f'ppoly_eval_geometry failed on device {index}:'
                               f' CUDA error {err}')
        geo = Geometry(g[0], g[1], g[2], g[3], (g[4], g[5]))
        _GEOMETRY[index] = geo
    return geo


class BackwardGeometry(NamedTuple):
    """What the backward's plan needs: the SM count, and threads per block,
    warps per block and the resident blocks per SM the chunking aims at, as
    `ppoly_eval_backward_geometry` reports them."""
    sms: int
    threads: int
    warps: int
    blocks_per_sm: int


def _backward_geometry(index: int) -> BackwardGeometry:
    geo = _GEOMETRY.get(('backward', index))
    if geo is None:
        g = (ctypes.c_int * 3)()
        _build.load('ppoly_eval').ppoly_eval_backward_geometry(g)
        geo = BackwardGeometry(_geometry(index).sms, g[0], g[1], g[2])
        _GEOMETRY[('backward', index)] = geo
    return geo


@functools.lru_cache(maxsize=1024)
def backward_plan(B: int, M: int, K: int, n: int, itemsize: int,
                  want_dcoeffs: bool, geo: BackwardGeometry) -> BackwardPlan:
    """The launch of one backward call on a card of geometry `geo`.

    A chunk is `tiles` consecutive tiles of `geo.threads` queries of one
    row, one block; chunks are sized so that the call has about SMs x
    `geo.blocks_per_sm` of them (each writes one partial table, so fewer,
    longer chunks trade parallelism for reduce traffic). Each warp keeps its
    own copy of the K x 4(n-1) coefficient sums while the table and the
    copies fit BWD_SMEM_BUDGET; beyond it warps pair up (halving the copies)
    down to one copy that all warps take turns on (n near 1,024)."""
    row_tiles = -(-M // geo.threads)
    tiles = max(1, -(-B * row_tiles // (geo.sms * geo.blocks_per_sm)))
    table = _smem_bytes(n, K, itemsize)
    copy = 4 * K * (n - 1) * itemsize if want_dcoeffs else 0
    copies = geo.warps
    while copies > 1 and table + copies * copy > BWD_SMEM_BUDGET:
        copies //= 2
    return BackwardPlan(tiles, -(-row_tiles // tiles), copies,
                        table + copies * copy)


@functools.lru_cache(maxsize=None)
def _smem_bytes(n: int, K: int, itemsize: int) -> int:
    """Shared memory of one staged table: K channels of 4(n-1) coefficients,
    the search keys (twice the binary lifting's first step, the largest
    power of two <= n - 2, or one key when n = 2) and x[n-1]."""
    step = 1 << (n - 2).bit_length() - 1 if n > 2 else 0
    return itemsize * (4 * K * (n - 1) + max(2 * step, 1) + 1)


@functools.lru_cache(maxsize=1024)
def launch_plan(B: int, M: int, K: int, n: int, itemsize: int, aligned: bool,
                geo: Geometry) -> LaunchPlan:
    """The launch of one call of the kernel on a card of geometry `geo`;
    `aligned`: q and out both start on a 16-byte boundary.

    Tiles of `geo.threads` x `loads` vectors within a row, walked
    grid-stride by one wave of blocks (SMs x the blocks an SM holds,
    `geo.blocks_per_sm[loads - 1]`, fewer when large tables fill its shared
    memory), or one block per tile when there are fewer tiles: a row shorter
    than a tile is one block. Two vectors per thread from TWO_LOADS_WAVES
    waves of work on, else one. 16-byte vector loads and stores when q and
    out are 16-byte aligned and M is a multiple of the vector width, so that
    every row starts aligned; otherwise the same kernel on scalars.
    """
    table = _smem_bytes(n, K, itemsize)
    vec = VECTOR_BYTES // itemsize
    if not aligned or M % vec:
        vec = 1
    by_smem = geo.smem_per_sm // (table + geo.smem_reserved)
    waves = [geo.sms * min(blocks, by_smem) for blocks in geo.blocks_per_sm]
    row_vectors = M // vec
    loads = 2 if B * row_vectors >= \
        TWO_LOADS_WAVES * waves[1] * geo.threads * 2 else 1
    tiles = B * -(-row_vectors // (geo.threads * loads))
    return LaunchPlan(vec, loads, min(waves[loads - 1], tiles), table)


def check_args(x, coeffs, q) -> int:
    """Raise on what the kernel does not take, devices aside; returns the
    channel count K."""
    dtype = q.dtype
    if dtype not in _DTYPES or x.dtype != dtype or coeffs.dtype != dtype:
        raise TypeError('ppoly_eval_cuda takes float32 or float64, one dtype '
                        f'for all; got {x.dtype}, {coeffs.dtype}, {q.dtype}')
    if torch.is_grad_enabled() and (x.requires_grad or coeffs.requires_grad
                                    or q.requires_grad):
        raise RuntimeError('ppoly_eval_cuda has no backward of its own: it '
                           'records no gradient; differentiate through '
                           'ops.splines.ppoly_eval (PpolyEval)')
    xs, cs, qs = x.shape, coeffs.shape, q.shape
    n = xs[0] if len(xs) == 1 else -1
    if not 2 <= n <= MAX_KNOTS:
        raise ValueError(f'x must be 1D with 2..{MAX_KNOTS} knots; got shape '
                         f'{tuple(xs)}')
    if len(qs) != 2:
        raise ValueError(f'q must be (B, M); got shape {tuple(qs)}')
    B = qs[0]
    if len(cs) not in (3, 4) or cs[-2] != n - 1 or cs[-1] != 4 or \
            cs[0] not in (1, B):
        raise ValueError(f'coeffs must be (1 or {B}, [K,] {n - 1}, 4); got '
                         f'{tuple(cs)}')
    K = cs[1] if len(cs) == 4 else 1
    if not 1 <= K <= MAX_CHANNELS:
        raise ValueError(f'coeffs has {K} channels; the kernel takes 1..'
                         f'{MAX_CHANNELS}')
    smem = _smem_bytes(n, K, _DTYPES[dtype])
    if smem > SMEM_LIMIT:
        raise ValueError(f'{K} channels of {n} knots need {smem} bytes of '
                         f'shared memory; one block takes at most '
                         f'{SMEM_LIMIT}')
    if not (x.is_contiguous() and coeffs.is_contiguous() and
            q.is_contiguous()):
        raise ValueError('ppoly_eval_cuda: x, coeffs and q must be contiguous')
    return K


def ppoly_eval_cuda(x: torch.Tensor, coeffs: torch.Tensor, q: torch.Tensor,
                    clamp: bool = True) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no synchronisation).
    Counts `ppoly.launches` (and `ppoly.launches_multi` with more than one
    channel) on q's device, and `ppoly.bytes` while a profiler runs
    (`utils.profiling`)."""
    K = check_args(x, coeffs, q)
    dev = q.device
    if not (dev.type == 'cuda' and x.device == dev and coeffs.device == dev):
        raise ValueError('ppoly_eval_cuda needs x, coeffs and q on one CUDA '
                         f'device; got {x.device}, {coeffs.device}, {dev}')
    B, M = q.shape
    out = torch.empty((B, K, M) if coeffs.ndim == 4 else (B, M),
                      dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    index = dev.index
    q_ptr, out_ptr = q.data_ptr(), out.data_ptr()
    n = x.shape[0]
    plan = launch_plan(B, M, K, n, _DTYPES[q.dtype],
                       not (q_ptr | out_ptr) % VECTOR_BYTES, _geometry(index))
    args = (x.data_ptr(), coeffs.data_ptr(), q_ptr, out_ptr, n, K, B, M,
            int(coeffs.shape[0] > 1), int(clamp), plan.vec, plan.loads,
            plan.grid, plan.smem)
    fn = _entry(q.dtype)
    if index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f'ppoly_eval kernel launch failed: CUDA error {err}')
    count('ppoly.launches', 1, index)
    if K > 1:
        count('ppoly.launches_multi', 1, index)
    count_bytes('ppoly.bytes', index, x, coeffs, q, out)
    return out


def ppoly_eval_plain(x: torch.Tensor, coeffs: torch.Tensor, q: torch.Tensor,
                     clamp: bool = True) -> torch.Tensor:
    """The same function in plain PyTorch: `ops.special.clip` (selects, so
    NaN stays NaN; JAX's derivative when autograd runs through it),
    searchsorted(right) and a gather per coefficient, the kernel's Horner
    order and its `+ (qq - qq)` NaN term. With 4D coefficients the interval
    index is found once and every channel gathers with it, so each channel
    equals a 3D call on its own table bit for bit."""
    from ..ops.special import clip
    n = x.shape[0]
    qq = clip(q, x[0], x[-1]) if clamp else q
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


# ---------------------------------------------------------------------------
# The backward
# ---------------------------------------------------------------------------

def check_grad_args(x, coeffs, q, grad_out) -> int:
    """`check_args`, and raise on a grad_out the backward does not take:
    q's dtype, contiguous, (B, M) for 3D coefficients and (B, K, M) for 4D
    ones. Returns K."""
    K = check_args(x, coeffs, q)
    want = (q.shape[0], K, q.shape[1]) if coeffs.ndim == 4 else tuple(q.shape)
    if tuple(grad_out.shape) != want or grad_out.dtype != q.dtype:
        raise ValueError(f'grad_out must be {want} {q.dtype}; got '
                         f'{tuple(grad_out.shape)} {grad_out.dtype}')
    if not grad_out.is_contiguous():
        raise ValueError('ppoly_eval_backward_cuda: grad_out must be '
                         'contiguous')
    return K


def ppoly_eval_backward_cuda(x, coeffs, q, grad_out, clamp: bool = True,
                             want_dq: bool = True, want_dcoeffs: bool = True):
    """Launch the backward kernel on the current stream (no
    synchronisation): (dq (B, M) or None, dcoeffs (coeffs' shape) or None).
    The coefficient sums run in a fixed order (csrc/ppoly_eval.cu), so the
    same inputs give the same bits on every call. Counts
    `ppoly.bwd_launches` and, while a profiler runs, `ppoly.bytes` on q's
    device."""
    K = check_grad_args(x, coeffs, q, grad_out)
    dev = q.device
    if not (dev.type == 'cuda' and x.device == dev and coeffs.device == dev
            and grad_out.device == dev):
        raise ValueError('ppoly_eval_backward_cuda needs x, coeffs, q and '
                         f'grad_out on one CUDA device; got {x.device}, '
                         f'{coeffs.device}, {dev}, {grad_out.device}')
    B, M = q.shape
    n = x.shape[0]
    dq = torch.empty_like(q) if want_dq else None
    dc = torch.empty_like(coeffs) if want_dcoeffs else None
    if B * M == 0 or not (want_dq or want_dcoeffs):
        if dc is not None:
            dc.zero_()
        return dq, dc
    index = dev.index
    plan = backward_plan(B, M, K, n, _DTYPES[q.dtype], want_dcoeffs,
                         _backward_geometry(index))
    partial = torch.empty(B * plan.chunks * K * 4 * (n - 1), dtype=q.dtype,
                          device=dev) if want_dcoeffs else None
    args = (x.data_ptr(), coeffs.data_ptr(), q.data_ptr(),
            grad_out.data_ptr(), None if dq is None else dq.data_ptr(),
            None if dc is None else dc.data_ptr(),
            None if partial is None else partial.data_ptr(), n, K, B, M,
            int(coeffs.shape[0] > 1), int(clamp), plan.tiles, plan.chunks,
            plan.copies, plan.smem)
    fn = _entry(q.dtype, 'backward')
    if index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError('ppoly_eval backward kernel launch failed: CUDA '
                           f'error {err}')
    count('ppoly.bwd_launches', 1, index)
    count_bytes('ppoly.bytes', index, x, coeffs, q, grad_out, dq, dc)
    return dq, dc


def clip_factor(x, q):
    """d clip(q, x[0], x[-1]) / dq with JAX's tie rule: 1 inside, 0.5 at a
    bound, 0 outside (and at NaN)."""
    inside = (q > x[0]) & (q < x[-1])
    tie = (q == x[0]) | (q == x[-1])
    return torch.where(inside, 1.0, torch.where(tie, 0.5, 0.0)).to(q.dtype)


def ppoly_eval_backward_plain(x, coeffs, q, grad_out, clamp: bool = True,
                              want_dq: bool = True,
                              want_dcoeffs: bool = True):
    """The backward kernel's function in plain PyTorch, in its op order:
    the clip's selects (`ops.special.clip`, so that autograd through this
    function differentiates the clamp with JAX's tie rule),
    searchsorted(right) (which puts a NaN query in the last interval, as
    JAX's searchsorted does), gathers, the derivative's Horner form
    ((3 c3) t + 2 c2) t + c1 summed over channels in order and times
    `clip_factor`, and the terms g (1, t, t^2, t^3) summed per table by
    `index_add_`. Returns (dq or None, dcoeffs or None)."""
    from ..ops.special import clip
    n = x.shape[0]
    B, M = q.shape
    c = coeffs if coeffs.ndim == 4 else coeffs[:, None]       # (Bc, K, ...)
    g = grad_out if coeffs.ndim == 4 else grad_out[:, None]   # (B, K, M)
    Bc, K = c.shape[:2]
    qq = clip(q, x[0], x[-1]) if clamp else q
    idx = torch.clamp(torch.searchsorted(x, qq, right=True) - 1, 0, n - 2)
    t = qq - x[idx]
    dq = dc = None
    if want_dq:
        ce = c.expand(B, -1, -1, -1)
        for k in range(K):
            c1, c2, c3 = (torch.gather(ce[:, k, :, j], 1, idx)
                          for j in (1, 2, 3))
            dk = g[:, k] * ((3.0 * c3 * t + 2.0 * c2) * t + c1)
            dq = dk if dq is None else dq + dk
        if clamp:
            dq = dq * clip_factor(x, q)
    if want_dcoeffs:
        p1 = g * t[:, None]
        p2 = p1 * t[:, None]
        terms = torch.stack([g, p1, p2, p2 * t[:, None]], -1)  # (B, K, M, 4)
        table = torch.arange(K, device=q.device)[None, :, None]
        if Bc > 1:
            table = table + K * torch.arange(B, device=q.device)[:, None, None]
        flat = (table * (n - 1) + idx[:, None, :]).expand(B, K, M)
        dc = torch.zeros(Bc * K * (n - 1), 4, dtype=q.dtype, device=q.device)
        dc.index_add_(0, flat.reshape(-1), terms.reshape(-1, 4))
        dc = dc.reshape(coeffs.shape)
    return dq, dc


def _derivative_table(coeffs):
    """The table of p' on the same knots: (c1, 2 c2, 3 c3, 0) per interval,
    elementwise."""
    c = coeffs.unbind(-1)
    return torch.stack([c[1], 2.0 * c[2], 3.0 * c[3], torch.zeros_like(c[0])],
                       -1)


# ---------------------------------------------------------------------------
# The second order
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1024)
def second_order_plan(B: int, M: int, K: int, n: int, itemsize: int,
                      want_dcoeffs: bool, with_v: bool,
                      geo: BackwardGeometry) -> BackwardPlan:
    """The launch of one call of the fused second-order kernel: the
    backward's plan for the same call (`backward_plan`: its tiles, chunks
    and copies, so that d/dcoeffs sums in the backward's order), with V's
    table after its shared memory, from the next 16-byte boundary, when
    `with_v`. Past 48 KB the kernel opts in to more dynamic shared memory;
    at most the backward's 96 KB and a 48 KB V fit the H100's 227 KB."""
    plan = backward_plan(B, M, K, n, itemsize, want_dcoeffs, geo)
    if not with_v:
        return plan
    return plan._replace(smem=-(-plan.smem // VECTOR_BYTES) * VECTOR_BYTES +
                         4 * K * (n - 1) * itemsize)


def check_second_order_args(x, coeffs, q, grad_out, u, V) -> int:
    """`check_grad_args`, and raise on cotangents the fused kernel does not
    take: u (q's shape) and V (the coefficients' shape), each None or of
    q's dtype and contiguous. Returns K."""
    K = check_grad_args(x, coeffs, q, grad_out)
    for name, a, want in (('u', u, q), ('V', V, coeffs)):
        if a is None:
            continue
        if a.shape != want.shape or a.dtype != q.dtype:
            raise ValueError(f'{name} must be {tuple(want.shape)} {q.dtype};'
                             f' got {tuple(a.shape)} {a.dtype}')
        if not a.is_contiguous():
            raise ValueError(f'ppoly_eval_second_order_cuda: {name} must be '
                             'contiguous')
    return K


def ppoly_eval_second_order_cuda(x, coeffs, q, grad_out, u, V,
                                 clamp: bool = True, want_coeffs: bool = True,
                                 want_q: bool = True,
                                 want_grad_out: bool = True):
    """Launch the fused second-order kernel on the current stream (no
    synchronisation): `ppoly_eval_second_order_composed`'s terms, bit for
    bit, from one pass over the queries, one launch (two with d/dcoeffs:
    the chunks, then the reduce). Returns (d_coeffs, d_q, d_grad_out), None
    where not asked for or zero. Counts `ppoly.second_order_launches` and,
    while a profiler runs, `ppoly.bytes` on q's device."""
    K = check_second_order_args(x, coeffs, q, grad_out, u, V)
    dev = q.device
    if not (dev.type == 'cuda' and all(
            a.device == dev for a in (x, coeffs, grad_out, u, V)
            if a is not None)):
        raise ValueError('ppoly_eval_second_order_cuda needs every tensor on '
                         f'one CUDA device; got q on {dev}')
    want_c = want_coeffs and u is not None
    any_u_v = u is not None or V is not None
    d_c = torch.empty_like(coeffs) if want_c else None
    d_q = torch.empty_like(q) if want_q and any_u_v else None
    d_g = torch.empty_like(grad_out) if want_grad_out and any_u_v else None
    B, M = q.shape
    if B * M == 0 or (d_c is None and d_q is None and d_g is None):
        if d_c is not None:
            d_c.zero_()
        return d_c, d_q, d_g
    n = x.shape[0]
    index = dev.index
    use_v = V is not None and (d_q is not None or d_g is not None)
    plan = second_order_plan(B, M, K, n, _DTYPES[q.dtype], want_c, use_v,
                             _backward_geometry(index))
    partial = torch.empty(B * plan.chunks * K * 4 * (n - 1), dtype=q.dtype,
                          device=dev) if want_c else None

    def ptr(a):
        return None if a is None else a.data_ptr()
    args = (x.data_ptr(), coeffs.data_ptr(), q.data_ptr(),
            grad_out.data_ptr(), ptr(u), ptr(V) if use_v else None, ptr(d_q),
            ptr(d_g), ptr(d_c), ptr(partial), n, K, B, M,
            int(coeffs.shape[0] > 1), int(clamp), plan.tiles, plan.chunks,
            plan.copies, plan.smem)
    fn = _entry(q.dtype, 'second_order')
    if index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError('ppoly_eval second-order kernel launch failed: '
                           f'CUDA error {err}')
    count('ppoly.second_order_launches', 1 + want_c, index)
    count_bytes('ppoly.bytes', index, x, coeffs, q, grad_out, u,
                V if use_v else None, d_c, d_q, d_g)
    return d_c, d_q, d_g


def ppoly_eval_second_order(x, coeffs, q, grad_out, u, V, clamp: bool = True,
                            want_coeffs: bool = True, want_q: bool = True,
                            want_grad_out: bool = True):
    """The second derivatives of `ppoly_eval` (the gradient of
    <u, dq> + <V, dcoeffs> to (coeffs, q, grad_out); the algebra is in
    `ppoly_eval_second_order_composed`), by device: the fused kernel
    (`ppoly_eval_second_order_cuda`) on CUDA tensors, with u and V made
    contiguous (autograd may hand over expanded cotangents), and the
    composition of the plain versions on CPU tensors. Returns (d_coeffs,
    d_q, d_grad_out), None where not asked for or zero."""
    if q.is_cuda:
        return ppoly_eval_second_order_cuda(
            x, coeffs, q, grad_out, None if u is None else u.contiguous(),
            None if V is None else V.contiguous(), clamp, want_coeffs, want_q,
            want_grad_out)
    return ppoly_eval_second_order_composed(x, coeffs, q, grad_out, u, V,
                                            clamp, want_coeffs, want_q,
                                            want_grad_out)


def ppoly_eval_second_order_composed(x, coeffs, q, grad_out, u, V,
                                     clamp: bool = True,
                                     want_coeffs: bool = True,
                                     want_q: bool = True,
                                     want_grad_out: bool = True):
    """The second derivatives of `ppoly_eval`: the gradient of
    <u, dq> + <V, dcoeffs> to (coeffs, q, grad_out), where (dq, dcoeffs) is
    the backward of `ppoly_eval` with grad_out g, and u (q's shape) and V
    (the coefficients' shape) are their cotangents, either None for 0.
    Returns (d_coeffs, d_q, d_grad_out), None where not asked for or zero.
    `ppoly_eval_second_order` takes this path on CPU tensors; on CUDA
    tensors the fused kernel computes the same terms bit for bit.

    With c(q) the clip factor (`clip_factor`; 1 without clamp), D the
    derivative table (c1, 2 c2, 3 c3, 0) and p_V the polynomial with
    coefficients V, every term is one launch of the forward or the backward
    kernel (of their plain versions on CPU tensors) on a table derived
    elementwise:

        d/dg      = u c(q) p'(qq) + p_V(qq)       forward on D, forward on V
        d/dq      = c(q) [c(q) sum_k u g_k p_k''(qq)] + c(q) sum_k g_k p_Vk'(qq)
                                                   backward dq on D with grad
                                                   u g, backward dq on V
                                                   with grad g
        d/dcoeffs = (0, S_0, 2 S_1, 3 S_2)        S: backward dcoeffs with
                                                   grad u c(q) g

    The clip factor enters d/dq squared: at a bound the second derivative
    takes 0.25 of p'', as JAX's does. A NaN query takes the backward's
    interval n-2. At an infinite query without clamp, where the forward is
    NaN, d/dq and d/dgrad_out are NaN (JAX's 'gather' strategy, whose
    forward is the end polynomial there, gives infinities). The kernel
    launches that the forward and backward wrappers count during the call
    (`ppoly.launches`, `ppoly.bwd_launches`) also count in
    `ppoly.second_order_launches`."""
    g = grad_out
    cuda = q.is_cuda
    launched = [0]

    def counted(kernel):
        def call(*args):
            launched[0] += 1
            return kernel(*args)
        return call
    fwd = counted(ppoly_eval_cuda) if cuda else ppoly_eval_plain
    bwd = counted(ppoly_eval_backward_cuda) if cuda else \
        ppoly_eval_backward_plain
    cq = clip_factor(x, q) if clamp else torch.ones_like(q)
    if coeffs.ndim == 4:                      # (B, M) -> (B, 1, M)
        def per_channel(a):
            return a[:, None]
    else:
        def per_channel(a):
            return a
    d_c = d_q = d_g = None
    if u is not None:
        D = _derivative_table(coeffs) if want_grad_out or want_q else None
        if want_grad_out:
            d_g = per_channel(u * cq) * fwd(x, D, q, clamp)
        if want_q:
            ug = (per_channel(u) * g).contiguous()
            d_q = cq * bwd(x, D, q, ug, clamp, True, False)[0]
        if want_coeffs:
            w = (per_channel(u * cq) * g).contiguous()
            S = bwd(x, coeffs, q, w, clamp, False, True)[1]
            d_c = torch.stack([torch.zeros_like(S[..., 0]), S[..., 0],
                               2.0 * S[..., 1], 3.0 * S[..., 2]], -1)
    if V is not None:
        V = V.contiguous()
        if want_grad_out:
            pv = fwd(x, V, q, clamp)
            d_g = pv if d_g is None else d_g + pv
        if want_q:
            dv = bwd(x, V, q, g, clamp, True, False)[0]
            d_q = dv if d_q is None else d_q + dv
    if not clamp:
        # an infinite query without clamp: the forward is NaN there (its
        # `+ (qq - qq)` term), and so are these terms, whatever order their
        # infinities would meet in (d/dcoeffs sums them as the backward does)
        inf = torch.isinf(q)
        if d_q is not None:
            d_q = torch.where(inf, math.nan, d_q)
        if d_g is not None:
            d_g = torch.where(per_channel(inf), math.nan, d_g)
    if launched[0]:
        count('ppoly.second_order_launches', launched[0], q.device)
    return d_c, d_q, d_g


class _PpolyEvalBackward(torch.autograd.Function):
    """`PpolyEval`'s backward as a Function of its own, so that a backward
    that records a graph (create_graph=True, a Hessian) can be
    differentiated once more. Forward: `ppoly_eval_backward_cuda` or
    `ppoly_eval_backward_plain`, by device, returning (dq, dcoeffs) with
    None for what is not asked for. Backward: `ppoly_eval_second_order`.
    A backward of this Function that records a graph (a third derivative)
    raises."""

    @staticmethod
    def forward(ctx, x, coeffs, q, grad_out, clamp, want_dq, want_dcoeffs):
        ctx.set_materialize_grads(False)
        ctx.clamp = clamp
        ctx.save_for_backward(x, coeffs, q, grad_out)
        fn = ppoly_eval_backward_cuda if q.is_cuda else \
            ppoly_eval_backward_plain
        return fn(x, coeffs, q, grad_out, clamp, want_dq, want_dcoeffs)

    @staticmethod
    def backward(ctx, u, V):
        if torch.is_grad_enabled():
            raise RuntimeError(
                'ppoly_eval has derivatives up to the second order: a '
                'backward of its second derivatives that records a graph '
                '(a third derivative) is not supported')
        x, coeffs, q, g = ctx.saved_tensors
        d_c, d_q, d_g = ppoly_eval_second_order(
            x, coeffs, q, g, u, V, ctx.clamp, *ctx.needs_input_grad[1:4])
        return None, d_c, d_q, d_g, None, None, None


class PpolyEval(torch.autograd.Function):
    """`ppoly_eval` with its gradient to q and to the coefficients: forward
    `ppoly_eval_cuda` or `ppoly_eval_plain`, backward
    `ppoly_eval_backward_cuda` or `ppoly_eval_backward_plain`, by device,
    through `_PpolyEvalBackward`, which has second derivatives.
    `ops.splines` calls it only while a gradient is being recorded."""

    @staticmethod
    def forward(ctx, x, coeffs, q, clamp):
        if ctx.needs_input_grad[0]:
            raise RuntimeError('ppoly_eval takes no gradient to its knots x: '
                               'pass a knot vector that does not require '
                               'grad')
        ctx.clamp = clamp
        ctx.save_for_backward(x, coeffs, q)
        if q.is_cuda:
            return ppoly_eval_cuda(x, coeffs, q, clamp)
        return ppoly_eval_plain(x, coeffs, q, clamp)

    @staticmethod
    def backward(ctx, grad_out):
        x, coeffs, q = ctx.saved_tensors
        # records a graph only when the backward does (create_graph=True)
        dq, dc = _PpolyEvalBackward.apply(
            x, coeffs, q, grad_out.contiguous(), ctx.clamp,
            ctx.needs_input_grad[2], ctx.needs_input_grad[1])
        return None, dc, dq, None
