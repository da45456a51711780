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
import functools
from typing import NamedTuple

import torch

from . import _build

#: number of kernel launches since the count was last reset
LAUNCHES = 0
#: of those, launches with more than one channel
LAUNCHES_MULTI = 0

MAX_KNOTS = 1024          # with K = 1: 40,936 bytes of table in f64, < 48 KB
MAX_CHANNELS = 4          # instantiated in csrc/ppoly_eval.cu
SMEM_LIMIT = 48 * 1024    # dynamic shared memory a block takes without opt-in
VECTOR_BYTES = 16         # one double2 / float4 load or store
TWO_LOADS_WAVES = 4       # two vectors per thread from this many waves of work

_ARGTYPES = ([ctypes.c_void_p] * 4 +
             [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong]
             + [ctypes.c_int] * 6 + [ctypes.c_void_p])
_DTYPES = {torch.float32: 4, torch.float64: 8}     # dtype -> itemsize
_ENTRIES: dict = {}       # dtype -> ctypes function, argtypes set once
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


def _entry(dtype: torch.dtype):
    fn = _ENTRIES.get(dtype)
    if fn is None:
        lib = _build.load('ppoly_eval')
        fn = lib.ppoly_eval_f64 if dtype == torch.float64 \
            else lib.ppoly_eval_f32
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _ENTRIES[dtype] = fn
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
    if x.requires_grad or coeffs.requires_grad or q.requires_grad:
        raise RuntimeError('ppoly_eval_cuda has no backward: the kernel is '
                           'forward only (gradients come with the HMC port)')
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
    """Launch the CUDA kernel on the current stream (no synchronisation)."""
    global LAUNCHES, LAUNCHES_MULTI
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
