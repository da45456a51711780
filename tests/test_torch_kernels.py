"""The CUDA kernels' wrappers, their build and their plain versions:
ppoly_eval (one table or K channels over one query set), its backward and
its second-order terms, the dispersion model's final stage, and the
Chebyshev series' Clenshaw recurrence (one or two series over one query
set).

This module imports neither jax nor victor_tpu, so it also runs on a GPU
machine without them:

    python -m pytest --noconftest tests/test_torch_kernels.py

Tests marked `cuda` need a CUDA device and nvcc, and skip without a card.
The helpers here make the inputs of tests/test_torch_splines.py too.
"""

import os

import numpy as np
import pytest
import torch

from victor_tpu_torch.kernels import _build, chebyshev, dispersion, ppoly
from victor_tpu_torch.ops import splines as tsp
from victor_tpu_torch.utils.profiling import total

torch.set_num_threads(1)


#: the lookup kernel's forward, backward and second-order launch counters
ALL_PPOLY = ('ppoly.launches', 'ppoly.bwd_launches',
             'ppoly.second_order_launches')


def _knots(rng, n):
    """A knot vector like r_v: 0.01, then n-1 points about 4 apart, each
    jittered by up to 1, up to 120."""
    inner = np.linspace(2.5, 120.0, n - 1) + rng.uniform(-1.0, 1.0, n - 1)
    return np.concatenate([[0.01], inner])


def _coeffs(x, y):
    """Spline coefficients (..., n-1, 4) of values y, built in numpy."""
    d = np.einsum('ij,...j->...i', tsp.cubic_deriv_operator(x), y)
    return tsp.hermite_coeffs(x, y, d)


def _queries(rng, x, shape):
    """Uniform queries reaching 5% of the span beyond both ends, with every
    knot, NaN, +inf and -inf planted at the front and 64 more knots
    scattered. (Farther out, the cubic end pieces grow past 100, where one
    ulp exceeds the 1e-13 tolerance.)"""
    span = x[-1] - x[0]
    q = rng.uniform(x[0] - 0.05 * span, x[-1] + 0.05 * span, shape)
    flat = q.reshape(-1)
    n = len(x)
    flat[:n] = x
    flat[n:n + 3] = [np.nan, np.inf, -np.inf]
    flat[rng.integers(n + 3, flat.size, 64)] = x[rng.integers(0, n, 64)]
    return q


def _t(a):
    return torch.as_tensor(a, dtype=torch.float64)


def _dispersion_inputs(rng, B, n_v, q, rows=None):
    """Final-stage inputs (x, c_vr, c_dvr, r_par, A, s_perp, iaH, resc_vel)
    as numpy arrays: a 31-knot spline with `rows` coefficient tables (B by
    default), distinct iaH and resc_vel per row, and NaN, out-of-range and
    near-knot entries planted (near-knot: s_perp = 0 and r_par = knot *
    resc_vel, within an ulp of the knot after the division)."""
    x = _knots(rng, 31)
    rows = B if rows is None else rows
    c_vr = _coeffs(x, rng.standard_normal((rows, 31)))
    c_dvr = _coeffs(x, rng.standard_normal((rows, 31)))
    s_perp = rng.uniform(0.0, 120.0, (B, q))
    r_par = rng.uniform(-130.0, 130.0, (B, n_v, q))
    A = r_par * rng.uniform(0.9, 1.1, (B, n_v, q))
    iaH = rng.uniform(0.009, 0.013, B)
    resc_vel = rng.uniform(0.95, 1.05, B)
    resc_vel[0] = 1.0
    s_perp[:, 0] = 0.0
    r_par[:, :, 0] = x[rng.integers(0, 31, (B, n_v))] * resc_vel[:, None]
    r_par[:, 0, 1:6] = [np.nan, 1e3, -1e3, 1e-4, 500.0]
    A[:, 1, 7] = np.nan
    return x, c_vr, c_dvr, r_par, A, s_perp, iaH, resc_vel


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(9)
    x = _knots(rng, 31)
    c = _coeffs(x, rng.standard_normal((2, 31)))
    q = _queries(rng, x, (2, 50))
    before = total('ppoly.launches')
    got = tsp.ppoly_eval(_t(x), _t(c), _t(q))
    want = ppoly.ppoly_eval_plain(_t(x), _t(c), _t(q))
    assert total('ppoly.launches') == before
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize('shared', [False, True])
def test_multi_channel_cpu_tensors_take_the_plain_version(shared):
    rng = np.random.default_rng(14)
    x = _knots(rng, 30)
    c = _coeffs(x, rng.standard_normal((3, 30) if shared else (2, 3, 30)))
    q = _queries(rng, x, (2, 60))
    before = (total('ppoly.launches'), total('ppoly.launches_multi'))
    got = tsp.ppoly_eval_multi(_t(x), _t(c), _t(q))
    assert (total('ppoly.launches'), total('ppoly.launches_multi')) == before
    want = ppoly.ppoly_eval_plain(_t(x), _t(c if not shared else c[None]),
                                  _t(q))
    assert got.shape == (2, 3, 60)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_kernel_wrapper_refuses_cpu_tensors():
    x = torch.linspace(0.0, 1.0, 5, dtype=torch.float64)
    with pytest.raises(ValueError, match='CUDA'):
        ppoly.ppoly_eval_cuda(x, torch.zeros(1, 4, 4, dtype=torch.float64),
                              torch.zeros(2, 3, dtype=torch.float64))


# an H100 SXM as the kernel's ppoly_eval_geometry reports it: 132 SMs, 228
# KB of shared memory per SM, 1 KB reserved per block, 256 threads per
# block, 8 or 6 resident blocks per SM
H100 = ppoly.Geometry(132, 228 * 1024, 1024, 256, (8, 6))
WAVE_1, WAVE_2 = (H100.sms * b for b in H100.blocks_per_sm)


def _plan(B, M, K=1, n=31, itemsize=8, q_ptr=0, out_ptr=0):
    aligned = not (q_ptr | out_ptr) % ppoly.VECTOR_BYTES
    return ppoly.launch_plan(B, M, K, n, itemsize, aligned, H100)


@pytest.mark.parametrize('B,M,K,itemsize', [
    (64, 150_000, 1, 8), (64, 150_000, 2, 8), (8, 150_000, 1, 8),
    (64, 150_000, 3, 4), (1, 9_600_000, 1, 8), (14_000, 150_000, 1, 4)])
def test_launch_plan_is_one_whole_wave(B, M, K, itemsize):
    """A call of at least a wave of tiles runs on exactly SMs x the blocks
    an SM holds, all resident at once; smaller ones on one block per tile,
    never a second wave."""
    plan = _plan(B, M, K, itemsize=itemsize)
    assert plan.grid == (WAVE_2 if plan.loads == 2 else WAVE_1)
    assert plan.smem == ppoly._smem_bytes(31, K, itemsize)
    small = _plan(8, 3000)                  # 8 rows of 6 tiles of 256 vectors
    assert (small.loads, small.grid) == (1, 8 * 6)
    assert _plan(1, 392, n=25).grid == 1
    # 1,024 knots: 40,936 bytes of table per block, five blocks per SM
    assert _plan(64, 150_000, n=1024).grid == H100.sms * 5
    assert _plan(8, 150_000).grid == WAVE_1


def test_launch_plan_loads_per_thread():
    """Two vectors per thread once a call holds TWO_LOADS_WAVES waves of
    such tiles (the batched likelihood's (64, 150000)); one for smaller
    calls (the samplers' (8, 150000)), which then spread over every thread
    of the wave."""
    assert _plan(64, 150_000).loads == 2
    assert _plan(64, 150_000, itemsize=4).loads == 2
    assert _plan(8, 150_000).loads == 1
    assert _plan(8, 150_000, itemsize=4).loads == 1
    edge = ppoly.TWO_LOADS_WAVES * WAVE_2 * H100.threads * 2 * 2
    assert _plan(1, edge).loads == 2 and _plan(1, edge - 2).loads == 1


@pytest.mark.parametrize('itemsize', [8, 4])
def test_launch_plan_vector_path_needs_alignment_and_even_rows(itemsize):
    """16-byte loads only when q and out are both 16-byte aligned and M is
    a multiple of the vector width; every other call runs the scalar path,
    which covers any offset and any M."""
    width = 16 // itemsize
    assert _plan(8, 150_000, itemsize=itemsize).vec == width
    assert _plan(8, 150_000, itemsize=itemsize, q_ptr=itemsize).vec == 1
    assert _plan(8, 150_000, itemsize=itemsize, out_ptr=itemsize).vec == 1
    assert _plan(8, 150_000, itemsize=itemsize, q_ptr=48, out_ptr=1024
                 ).vec == width
    assert _plan(8, 150_001, itemsize=itemsize).vec == 1
    assert _plan(8, 150_000 + width, itemsize=itemsize).vec == width
    scalar = _plan(8, 3001, itemsize=itemsize)
    assert scalar.vec == 1 and scalar.grid == 8 * -(-3001 // H100.threads)


def test_launch_plan_small_rows_take_one_block_each():
    """Rows shorter than a tile (the Chebyshev nodes: 25 or 49 queries) take
    one block each on the scalar path when M is odd or under the vector
    width, with one vector or one query per thread; a block per row also
    for tables that fill most of a block's shared memory."""
    plan = _plan(8, 49)
    assert (plan.vec, plan.loads, plan.grid) == (1, 1, 8)
    assert plan.smem == ppoly._smem_bytes(31, 1, 8)
    assert _plan(64, 25).grid == 64
    assert (_plan(3, 1).vec, _plan(3, 1).grid) == (1, 3)
    assert (_plan(16, 64).vec, _plan(16, 64).grid) == (2, 16)
    big = _plan(8, 49, K=4, n=300)          # 42,376 bytes per table
    assert big.grid == 8 and big.smem <= ppoly.SMEM_LIMIT
    # with few rows no block walks more than one tile
    assert _plan(H100.sms * 8 - 1, 49).grid == H100.sms * 8 - 1


def test_launch_plan_grid_stays_in_range_for_a_huge_batch():
    """An unchunked batch of 14,000 points at BOSS size (B * M = 2.1e9
    queries, past 2^31), and 2^31 - 1 rows of 49 queries: one wave, far
    below 2^31 - 1."""
    B, M = 14_000, 150_000
    for itemsize, q_ptr in ((8, 0), (4, 0), (8, 8)):
        plan = _plan(B, M, itemsize=itemsize, q_ptr=q_ptr)
        assert plan.grid == WAVE_2 <= 2 ** 31 - 1
    assert _plan(2 ** 31 - 1, 49).grid == WAVE_2


def test_smem_bytes_without_allocating():
    """Shared memory from the itemsize: K tables, the search keys (twice
    the first lifting step: 32 keys for 25..33 knots) and x[n-1]."""
    assert ppoly._smem_bytes(31, 1, 8) == 8 * (4 * 30 + 32 + 1)
    assert ppoly._smem_bytes(30, 2, 8) == 8 * (8 * 29 + 32 + 1)
    assert ppoly._smem_bytes(31, 1, 4) == 4 * (4 * 30 + 32 + 1)
    assert ppoly._smem_bytes(2, 1, 8) == 8 * (4 + 1 + 1)
    assert ppoly._smem_bytes(1024, 1, 8) == 8 * (4 * 1023 + 1024 + 1)
    assert ppoly._smem_bytes(1024, 1, 8) <= ppoly.SMEM_LIMIT


# the backward kernel as ppoly_eval_backward_geometry reports it on an H100
# SXM: 132 SMs, 256 threads (8 warps) per block, 4 blocks per SM aimed at
H100_BWD = ppoly.BackwardGeometry(132, 256, 8, 4)


@pytest.mark.parametrize('B,M,K,n', [(8, 150_000, 1, 31), (8, 150_000, 2, 30),
                                     (64, 150_000, 1, 31), (1, 9_600_000, 1, 25),
                                     (8, 49, 1, 31), (16, 1, 1, 31)])
def test_backward_plan_covers_every_query_in_about_a_wave(B, M, K, n):
    """Chunks of whole tiles cover each row once, and a call that has the
    work for it runs about SMs x 4 chunks (one partial table each); every
    warp keeps its own accumulators at the path's table sizes."""
    plan = ppoly.backward_plan(B, M, K, n, 8, True, H100_BWD)
    tile = H100_BWD.threads * plan.tiles
    assert (plan.chunks - 1) * tile < M <= plan.chunks * tile
    wave = H100_BWD.sms * H100_BWD.blocks_per_sm
    if B * -(-M // H100_BWD.threads) >= wave:
        assert abs(B * plan.chunks - wave) < wave / plan.tiles + B
    else:
        assert plan.tiles == 1
    assert plan.copies == H100_BWD.warps
    assert plan.smem == ppoly._smem_bytes(n, K, 8) + 8 * 4 * K * (n - 1) * 8


def test_backward_plan_shares_accumulators_when_shared_memory_is_short():
    """At 1,024 knots one copy of the sums no longer fits eight times: the
    warps share fewer copies (one, taking turns), past 48 KB of dynamic
    shared memory; a call without dcoeffs keeps only the table."""
    big = ppoly.backward_plan(16, 3000, 1, 1024, 8, True, H100_BWD)
    assert big.copies == 1
    assert big.smem == ppoly._smem_bytes(1024, 1, 8) + 4 * 1023 * 8 > 48 * 1024
    mid = ppoly.backward_plan(16, 3000, 1, 200, 8, True, H100_BWD)
    assert 1 < mid.copies < H100_BWD.warps
    assert H100_BWD.warps % mid.copies == 0
    assert mid.smem <= ppoly.BWD_SMEM_BUDGET
    dq_only = ppoly.backward_plan(16, 3000, 1, 1024, 8, False, H100_BWD)
    assert dq_only.smem == ppoly._smem_bytes(1024, 1, 8)


@pytest.mark.parametrize('case,match', [
    ('cpu', 'CUDA'), ('grad_shape', 'grad_out must be'),
    ('grad_dtype', 'grad_out must be'), ('grad_strides', 'contiguous'),
    ('coeff_rows', 'coeffs must be')])
def test_backward_wrapper_refuses_on_cpu(case, match):
    """The backward's checks run before any launch, on CPU tensors too."""
    f64 = torch.float64
    x = torch.linspace(0.0, 1.0, 30, dtype=f64)
    c = torch.zeros(2, 29, 4, dtype=f64)
    q = torch.zeros(2, 7, dtype=f64)
    g = torch.zeros(2, 7, dtype=f64)
    bad = {'cpu': (x, c, q, g), 'grad_shape': (x, c, q, g[:, :6]),
           'grad_dtype': (x, c, q, g.float()),
           'grad_strides': (x, c, q, torch.zeros(7, 2, dtype=f64).t()),
           'coeff_rows': (x, torch.zeros(3, 29, 4, dtype=f64), q, g)}[case]
    before = total('ppoly.bwd_launches')
    with pytest.raises(ValueError, match=match):
        ppoly.ppoly_eval_backward_cuda(*bad)
    assert total('ppoly.bwd_launches') == before


@pytest.mark.parametrize('B,M,K,n,want_dc,with_v', [
    (4, 150_000, 1, 31, True, True), (1, 600_000, 1, 25, False, True),
    (8, 150_000, 2, 30, True, False), (16, 3000, 4, 30, True, True),
    (16, 3000, 1, 1024, True, True), (16, 3000, 1, 200, True, True),
    (16, 3000, 1, 1024, False, False), (8, 49, 3, 31, False, True)])
def test_second_order_plan_takes_the_backward_plan(B, M, K, n, want_dc,
                                                   with_v):
    """The fused second-order kernel sums d/dcoeffs in the backward's order:
    its plan takes the backward's tiles, chunks and copies for the same
    call; its shared memory holds the backward's (table, keys, copies),
    then V's table from a 16-byte boundary, within the H100's 227 KB."""
    for itemsize in (8, 4):
        bwd = ppoly.backward_plan(B, M, K, n, itemsize, want_dc, H100_BWD)
        plan = ppoly.second_order_plan(B, M, K, n, itemsize, want_dc, with_v,
                                       H100_BWD)
        assert plan[:3] == bwd[:3]
        table = ppoly._smem_bytes(n, K, itemsize)
        copies = bwd.copies * 4 * K * (n - 1) * itemsize if want_dc else 0
        v = 4 * K * (n - 1) * itemsize if with_v else 0
        assert bwd.smem == table + copies
        assert plan.smem == (-(-bwd.smem // 16) * 16 + v if with_v
                             else bwd.smem)
        assert plan.smem <= 227 * 1024


@pytest.mark.parametrize('case,match', [
    ('cpu', 'CUDA'), ('u_shape', 'u must be'), ('u_dtype', 'u must be'),
    ('u_strides', 'contiguous'), ('V_shape', 'V must be'),
    ('V_dtype', 'V must be'), ('V_strides', 'contiguous'),
    ('grad_shape', 'grad_out must be'), ('coeff_rows', 'coeffs must be'),
    ('five_channels', 'channels')])
def test_second_order_wrapper_refuses_on_cpu(case, match):
    """The fused second-order kernel's checks run before any launch, on CPU
    tensors too, and count no launch."""
    f64 = torch.float64
    x = torch.linspace(0.0, 1.0, 30, dtype=f64)
    c = torch.zeros(2, 29, 4, dtype=f64)
    q = torch.zeros(2, 7, dtype=f64)
    g = torch.zeros(2, 7, dtype=f64)
    good = (x, c, q, g, q.clone(), c.clone())
    bad = {'cpu': good,
           'u_shape': (x, c, q, g, q[:, :6], c),
           'u_dtype': (x, c, q, g, q.float(), c),
           'u_strides': (x, c, q, g, torch.zeros(7, 2, dtype=f64).t(), c),
           'V_shape': (x, c, q, g, q, c[:1]),
           'V_dtype': (x, c, q, g, None, c.float()),
           'V_strides': (x, c, q, g, q,
                         torch.zeros(2, 4, 29, dtype=f64).transpose(1, 2)),
           'grad_shape': (x, c, q, g[:, :6], q, c),
           'coeff_rows': (x, torch.zeros(3, 29, 4, dtype=f64), q, g, q, None),
           'five_channels': (x, torch.zeros(2, 5, 29, 4, dtype=f64), q,
                             torch.zeros(2, 5, 7, dtype=f64), q, None)}[case]
    before = total('ppoly.second_order_launches')
    with pytest.raises(ValueError, match=match):
        ppoly.ppoly_eval_second_order_cuda(*bad)
    assert total('ppoly.second_order_launches') == before


@pytest.mark.parametrize('with_u,with_v', [(True, True), (True, False),
                                           (False, True)])
@pytest.mark.parametrize('wants', [(True, True, True), (False, True, False),
                                   (True, False, True)])
@pytest.mark.parametrize('K', [1, 3])
def test_second_order_on_cpu_takes_the_plain_composition(with_u, with_v,
                                                         wants, K):
    """On CPU tensors ppoly_eval_second_order is the composition of the
    plain versions (ppoly_eval_second_order_composed), bit for bit, and
    within 1e-12 of autograd through the plain backward; it returns None
    where a term is not asked for or cannot be reached (d/dcoeffs without
    u), and counts no launch."""
    rng = np.random.default_rng(31 + K)
    B, M, n = 3, 40, 12
    x_np, c_np, q_np = _edge_inputs(rng, B, M, n, K, False, 0)
    g_np = rng.standard_normal((B, K, M) if K > 1 else (B, M))
    x, c, q, g = (_t(a) for a in (x_np, c_np, q_np[:B * M].reshape(B, M),
                                  g_np))
    u = _t(rng.standard_normal((B, M))) if with_u else None
    V = _t(rng.standard_normal(c_np.shape)) if with_v else None
    before = tuple(map(total, ALL_PPOLY))
    got = ppoly.ppoly_eval_second_order(x, c, q, g, u, V, True, *wants)
    assert tuple(map(total, ALL_PPOLY)) == before
    composed = ppoly.ppoly_eval_second_order_composed(x, c, q, g, u, V, True,
                                                      *wants)
    want = _second_order_plain(x, c, q, g,
                               torch.zeros_like(q) if u is None else u,
                               torch.zeros_like(c) if V is None else V, True)
    reached = (with_u, with_u or with_v, with_u or with_v)
    for a, b, p, asked, reach in zip(got, composed, want, wants, reached):
        if not (asked and reach):
            assert a is None and b is None
            continue
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
        assert torch.equal(torch.isnan(a), torch.isnan(p))
        fin = torch.isfinite(p)
        assert float((a - p)[fin].abs().max()) <= \
            1e-12 * float(p[fin].abs().max())


@pytest.mark.parametrize('case,error,match', [
    ('cpu', ValueError, 'CUDA'),
    ('grad', RuntimeError, 'no backward'),
    ('mixed_dtypes', TypeError, 'one dtype'),
    ('int', TypeError, 'float32 or float64'),
    ('five_channels', ValueError, 'channels'),
    ('smem', ValueError, 'shared memory'),
    ('too_many_knots', ValueError, 'knots'),
    ('coeff_rows', ValueError, 'coeffs must be'),
    ('q_1d', ValueError, 'q must be'),
    ('not_contiguous', ValueError, 'contiguous'),
])
def test_kernel_wrapper_refuses_on_cpu(case, error, match):
    """What the wrapper refuses, checked before any launch: the kernel's
    checks run on CPU tensors too, and a CPU tensor that passes them is
    refused for its device."""
    f64 = torch.float64
    x = torch.linspace(0.0, 1.0, 30, dtype=f64)
    c = torch.zeros(2, 29, 4, dtype=f64)
    q = torch.zeros(2, 7, dtype=f64)
    bad = {
        'cpu': (x, c, q),
        'grad': (x, c.clone().requires_grad_(), q),
        'mixed_dtypes': (x, c.float(), q),
        'int': (x.long(), c.long(), q.long()),
        'five_channels': (x, torch.zeros(2, 5, 29, 4, dtype=f64), q),
        'smem': (torch.linspace(0.0, 1.0, 400, dtype=f64),
                 torch.zeros(2, 4, 399, 4, dtype=f64), q),
        'too_many_knots': (torch.linspace(0.0, 1.0, ppoly.MAX_KNOTS + 1,
                                          dtype=f64),
                           torch.zeros(2, ppoly.MAX_KNOTS, 4, dtype=f64), q),
        'coeff_rows': (x, torch.zeros(3, 29, 4, dtype=f64), q),
        'q_1d': (x, c, q[0]),
        'not_contiguous': (x, c, torch.zeros(7, 2, dtype=f64).t()),
    }[case]
    before = total('ppoly.launches')
    with pytest.raises(error, match=match):
        ppoly.ppoly_eval_cuda(*bad)
    assert total('ppoly.launches') == before


@pytest.mark.parametrize('name', ['ppoly_eval', 'dispersion_final',
                                  'chebyshev_eval'])
def test_build_without_nvcc_raises(monkeypatch, tmp_path, name):
    monkeypatch.setattr(_build.shutil, 'which', lambda name: None)
    monkeypatch.setattr(_build, 'DEFAULT_NVCC', str(tmp_path / 'no-nvcc'))
    with pytest.raises(RuntimeError, match='nvcc not found'):
        _build.build(name, build_dir=tmp_path)


@pytest.mark.parametrize('shared', [False, True])
def test_dispersion_cpu_tensors_take_the_plain_version(shared):
    rng = np.random.default_rng(16)
    args = [_t(a) for a in _dispersion_inputs(rng, 3, 4, 20,
                                              rows=1 if shared else None)]
    before = total('dispersion.launches')
    got = tsp.dispersion_final(*args)
    want = dispersion.dispersion_final_plain(*args)
    assert total('dispersion.launches') == before
    for g, w in zip(got, want):
        assert g.shape == (3, 4, 20)
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert torch.isnan(got[3]).any() and torch.isfinite(got[3]).any()


def _bad(args, i, value):
    out = list(args)
    out[i] = value
    return out


@pytest.mark.parametrize('case,error', [
    ('f32_r_par', TypeError), ('int_x', TypeError),
    ('s_perp_shape', ValueError), ('A_shape', ValueError),
    ('coeff_rows', ValueError), ('coeff_width', ValueError),
    ('mixed_sharing', ValueError), ('iaH_shape', ValueError),
    ('too_many_knots', ValueError),
])
def test_dispersion_dispatcher_rejects_bad_inputs(case, error):
    rng = np.random.default_rng(17)
    args = [_t(a) for a in _dispersion_inputs(rng, 3, 4, 20)]
    x, c_vr, c_dvr, r_par, A, s_perp, iaH, resc_vel = args
    n = dispersion.MAX_KNOTS + 1
    bad = {
        'f32_r_par': _bad(args, 3, r_par.float()),
        'int_x': _bad(args, 0, x.long()),
        's_perp_shape': _bad(args, 5, s_perp[:, :-1]),
        'A_shape': _bad(args, 4, A[:, :-1]),
        'coeff_rows': _bad(args, 1, c_vr[:2]),
        'coeff_width': _bad(args, 2, c_dvr[..., :3]),
        'mixed_sharing': _bad(args, 2, c_dvr[:1]),
        'iaH_shape': _bad(args, 6, iaH[:, None]),
        'too_many_knots': [torch.arange(n, dtype=torch.float64),
                           torch.zeros(3, n - 1, 4, dtype=torch.float64),
                           torch.zeros(3, n - 1, 4, dtype=torch.float64),
                           *args[3:]],
    }[case]
    with pytest.raises(error):
        tsp.dispersion_final(*bad)


def test_dispersion_kernel_wrapper_refuses_cpu_tensors():
    rng = np.random.default_rng(18)
    args = [_t(a) for a in _dispersion_inputs(rng, 2, 3, 10)]
    with pytest.raises(ValueError, match='CUDA'):
        dispersion.dispersion_final_cuda(*args)


def _chebyshev_inputs(rng, B, S, K, tail):
    """Clenshaw inputs as numpy arrays: S series (coef (B, K), a (B,),
    b (B,)), each on its own domain inside [0.01, 130], and q (B, *tail)
    reaching 10% of the widest span beyond both ends, with the domain's end
    points of each series, NaN, +inf, -inf and queries far out on both
    sides planted in every row."""
    series = []
    for _ in range(S):
        a = rng.uniform(0.01, 5.0, B)
        series.append((rng.standard_normal((B, K)) / (1.0 + np.arange(K)),
                       a, a + rng.uniform(60.0, 125.0, B)))
    lo = min(s[1].min() for s in series)
    hi = max(s[2].max() for s in series)
    q = rng.uniform(lo - 0.1 * (hi - lo), hi + 0.1 * (hi - lo),
                    (B,) + tuple(tail))
    flat = q.reshape(B, -1)
    planted = np.column_stack([s[i] for s in series for i in (1, 2)]
                              + [np.tile([np.nan, np.inf, -np.inf, -1e6, 1e6],
                                         (B, 1))])
    n = min(planted.shape[1], flat.shape[1])
    flat[:, :n] = planted[:, :n]
    return series, q


def _torch_series(series, **kw):
    return [tuple(torch.as_tensor(v, **kw) if kw else _t(v) for v in s)
            for s in series]


@pytest.mark.parametrize('case,error,match', [
    ('cpu', ValueError, 'CUDA'),
    ('grad', RuntimeError, 'records no gradient'),
    ('int', TypeError, 'float32 or float64'),
    ('mixed_dtypes', TypeError, 'one dtype'),
    ('not_contiguous', ValueError, 'contiguous'),
    ('too_many_terms', ValueError, 'terms'),
    ('no_terms', ValueError, 'terms'),
    ('no_series', ValueError, 'series'),
    ('three_series', ValueError, 'series'),
    ('two_term_counts', ValueError, 'one K'),
    ('domain_rows', ValueError, 'a and b must be'),
    ('query_rows', ValueError, r'coef must be \(2, K\)'),
    ('q_3d', ValueError, 'q must be'),
    ('transpose_cpu', ValueError, 'CUDA'),
    ('transpose_g_shape', ValueError, 'g must be'),
    ('transpose_terms', ValueError, 'terms'),
    ('transpose_dtypes', TypeError, 'one dtype'),
])
def test_chebyshev_wrapper_refuses_before_any_launch(case, error, match):
    """What the Clenshaw kernels' wrappers (the evaluation and the
    transpose) refuse, checked before any launch: their checks run on CPU
    tensors too, and a CPU tensor that passes them is refused for its
    device."""
    f64 = torch.float64
    coef = torch.zeros(3, 49, dtype=f64)
    a, b = torch.zeros(3, dtype=f64), torch.ones(3, dtype=f64)
    q = torch.zeros(3, 10, dtype=f64)
    one = (coef, a, b)
    n = chebyshev.MAX_TERMS + 1
    if case.startswith('transpose'):
        fn = chebyshev.chebyshev_transpose_cuda
        args = {'transpose_cpu': (q, a, b, q, 49),
                'transpose_g_shape': (torch.zeros(3, 5, dtype=f64), a, b, q, 49),
                'transpose_terms': (q, a, b, q, n),
                'transpose_dtypes': (q.float(), a, b, q, 49)}[case]
    else:
        fn = chebyshev.chebyshev_eval_cuda
        args = {
            'cpu': ([one, one], q),
            'grad': ([(coef.clone().requires_grad_(), a, b)], q),
            'int': ([(coef.long(), a.long(), b.long())], q.long()),
            'mixed_dtypes': ([one], q.float()),
            'not_contiguous': ([one], torch.zeros(10, 3, dtype=f64).t()),
            'too_many_terms': ([(torch.zeros(3, n, dtype=f64), a, b)], q),
            'no_terms': ([(torch.zeros(3, 0, dtype=f64), a, b)], q),
            'no_series': ([], q),
            'three_series': ([one] * 3, q),
            'two_term_counts': ([one, (coef[:, :25].contiguous(), a, b)], q),
            'domain_rows': ([(coef, a[:2], b)], q),
            'query_rows': ([one], q[:2]),
            'q_3d': ([one], q.reshape(3, 2, 5)),
        }[case]
    names = ('chebyshev.launches', 'chebyshev.transpose_launches')
    before = [total(name) for name in names]
    with pytest.raises(error, match=match):
        fn(*args)
    assert [total(name) for name in names] == before


@pytest.mark.parametrize('S', [1, 2])
@pytest.mark.parametrize('grad', [False, True])
def test_chebyshev_router_takes_the_plain_recurrence(monkeypatch, S, grad):
    """ops.splines.chebyshev_eval_multi sends CPU tensors, with or without a
    recorded gradient, to the plain recurrence: no kernel wrapper, no
    ChebyshevEval, no `chebyshev.plain_cuda` count (that counts CUDA calls
    only), the plain version's bits, and a gradient that reaches every
    input."""
    def refuse(*args):
        raise AssertionError('the CUDA route was taken')
    monkeypatch.setattr(chebyshev, 'chebyshev_eval_cuda', refuse)
    monkeypatch.setattr(chebyshev.ChebyshevEval, 'apply', refuse)
    rng = np.random.default_rng(40 + S)
    series, q = _chebyshev_inputs(rng, 3, S, 25, (4, 30))
    series, q = _torch_series(series), _t(q)
    flat = [t for s in series for t in s] + [q]
    if grad:
        for t in flat:
            t.requires_grad_()
    names = ('chebyshev.launches', 'chebyshev.plain_cuda')
    before = [total(n) for n in names]
    got = tsp.chebyshev_eval_multi(series, q)
    assert [total(n) for n in names] == before
    assert len(got) == S and all(g.shape == (3, 4, 30) for g in got)
    with torch.no_grad():
        want = [chebyshev.chebyshev_eval_plain(*s, q) for s in series]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.detach().numpy(), w.numpy())
        assert g.requires_grad == grad
    if grad:
        sum(g[torch.isfinite(g)].sum() for g in got).backward()
        assert all(t.grad is not None for t in flat)


@pytest.mark.parametrize('B,M,want', [
    (64, 150_000, 147),        # 75,000 pairs over 512 per block
    (64, 3_000, 3),
    (8, 49, 1),
    (1, 1, 1),
    (2 ** 29, 150_000, 3),     # the grid's limit of 2**31 - 1 blocks
])
def test_chebyshev_blocks_per_row(B, M, want):
    """The evaluation's blocks per row: PAIRS_PER_THREAD pairs of queries
    per thread, at least one block, and B times it within the grid's
    limit."""
    got = chebyshev.blocks_per_row(B, M)
    assert got == want
    assert B * got <= 2 ** 31 - 1


@pytest.mark.parametrize('B,M,want', [
    (64, 150_000, 37),         # 4 passes of 4 queries per thread
    (64, 3_000, 1),
    (2 ** 29, 150_000, 3),
])
def test_chebyshev_transpose_blocks_per_row(B, M, want):
    """The transpose's blocks per row: PASSES passes of POINTS queries per
    thread, at least one block, and B times it within the grid's limit."""
    got = chebyshev.transpose_blocks_per_row(B, M)
    assert got == want
    assert B * got <= 2 ** 31 - 1


def _chebyshev_grads(fn, series, q, weights, probe):
    """The gradient of sum_s <out_s, weights_s> to q and every series'
    coef, a and b through `fn`, and the derivative of that gradient along
    `probe` (a Hessian-vector product), each input as a fresh leaf."""
    leaves = [q.clone().requires_grad_()] + [
        t.clone().requires_grad_() for s in series for t in s]
    qq, flat = leaves[0], leaves[1:]
    outs = fn([flat[i:i + 3] for i in range(0, len(flat), 3)], qq)
    loss = sum((o * w).nansum() for o, w in zip(outs, weights))
    grads = torch.autograd.grad(loss, leaves, create_graph=True)
    hvp = torch.autograd.grad(
        sum((g * p).nansum() for g, p in zip(grads, probe)), leaves,
        allow_unused=True)
    return ([o.detach() for o in outs], [g.detach() for g in grads],
            [torch.zeros_like(t) if h is None else h
             for h, t in zip(hvp, leaves)])


def _via_function(series, q):
    return chebyshev.ChebyshevEval.apply(q, *[t for s in series for t in s])


def _via_plain(series, q):
    return [chebyshev.chebyshev_eval_plain(*s, q) for s in series]


@pytest.mark.parametrize('S', [1, 2])
@pytest.mark.parametrize('K', [2, 3, 25, 49])
def test_chebyshev_gradient_equals_plain_autograd(S, K):
    """ChebyshevEval's composed gradient (its CPU pieces: the plain
    recurrence for the derivative's series and the plain transpose) against
    the plain recurrence's own autograd, to q, coef, a and b, first order
    and Hessian-vector products: within 1e-12 of each gradient's largest
    entry, the same values bit for bit, and NaN in the same places. The
    queries hold the domain's end points (JAX's tie rule of the clip),
    queries far outside, NaN and infinities. (A constant series, K = 1,
    has no slope in u; there the two differ in where NaN appears.)"""
    rng = np.random.default_rng(80 + 3 * S + K)
    series, q = _chebyshev_inputs(rng, 3, S, K, (40,))
    series, q = _torch_series(series), _t(q)
    weights = [_t(rng.standard_normal(q.shape)) for _ in range(S)]
    probe = [_t(rng.standard_normal(t.shape))
             for t in [q] + [t for s in series for t in s]]
    got = _chebyshev_grads(_via_function, series, q, weights, probe)
    want = _chebyshev_grads(_via_plain, series, q, weights, probe)
    for o, w in zip(got[0], want[0]):
        assert torch.equal(o.nan_to_num(7.0), w.nan_to_num(7.0))
    for kind in (1, 2):
        for g, w in zip(got[kind], want[kind]):
            assert torch.equal(torch.isnan(g), torch.isnan(w))
            scale = float(w.nan_to_num(0.0).abs().max())
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                       atol=1e-12 * max(scale, 1e-300))


@pytest.mark.parametrize('S', [1, 2])
def test_chebyshev_function_passes_gradcheck(S):
    """ChebyshevEval on the CPU against finite differences, first and
    second order (torch.autograd.gradcheck and gradgradcheck), to q and to
    every series' coef, a and b, with the queries inside the domain (the
    clip's kink is not differentiable)."""
    rng = np.random.default_rng(90 + S)
    series, _ = _chebyshev_inputs(rng, 2, S, 7, (1,))
    q = _t(rng.uniform(6.0, 60.0, (2, 5))).requires_grad_()
    flat = [t.requires_grad_() for s in _torch_series(series) for t in s]
    assert torch.autograd.gradcheck(_via_function_flat, (q, *flat))
    assert torch.autograd.gradgradcheck(_via_function_flat, (q, *flat))


def _via_function_flat(q, *flat):
    return chebyshev.ChebyshevEval.apply(q, *flat)


@pytest.mark.parametrize('K', [1, 2, 9, 49])
def test_chebyshev_transpose_plain_sums_g_times_t_k(K):
    """chebyshev_transpose_plain's entry k is sum_m g T_k(u) with u the
    evaluation's clipped query, T_k from numpy's chebvander;
    derivative_coefficients equals numpy's chebder (with a zero last
    term)."""
    rng = np.random.default_rng(100 + K)
    (coef, a, b), = _chebyshev_inputs(rng, 3, 1, K, (40,))[0]
    q = rng.uniform(-10.0, 140.0, (3, 40))
    g = rng.standard_normal((3, 40))
    u = np.clip((2.0 * q - (a + b)[:, None]) / (b - a)[:, None], -1.0, 1.0)
    want = np.einsum('bm,bmk->bk', g, np.polynomial.chebyshev.chebvander(
        u, K - 1))
    got = chebyshev.chebyshev_transpose_plain(_t(g), _t(a), _t(b), _t(q), K)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    der = chebyshev.derivative_coefficients(_t(coef)).numpy()
    want_der = np.stack([np.append(np.polynomial.chebyshev.chebder(c),
                                   np.zeros(1 if K > 1 else 0))[:K]
                         for c in coef])
    np.testing.assert_allclose(der, want_der, rtol=1e-14, atol=1e-14)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: run on the GPU machine with '
                    '`python -m pytest --noconftest tests/test_torch_kernels.py`')
    return torch.device('cuda')


@pytest.mark.cuda
def test_wrappers_count_launches_and_bytes_on_their_device(cuda_device):
    """Each wrapper counts its launches under its device's index, and while
    a profiler runs the bytes of the tensors it reads once and writes once
    (none without a profiler)."""
    from torch.profiler import ProfilerActivity, profile
    from victor_tpu_torch.utils.profiling import nbytes
    rng = np.random.default_rng(23)
    x_np = _knots(rng, 31)
    c_np = _coeffs(x_np, rng.standard_normal((8, 31)))
    x, c, q, g, u, V = (torch.as_tensor(a, device=cuda_device)
                        for a in (x_np, c_np, _queries(rng, x_np, (8, 500)),
                                  rng.standard_normal((8, 500)),
                                  rng.standard_normal((8, 500)),
                                  rng.standard_normal(c_np.shape)))
    index = q.device.index
    names = ALL_PPOLY + ('ppoly.bytes',)

    def launch_all():
        before = [total(n, index) for n in names]
        outs = (ppoly.ppoly_eval_cuda(x, c, q),
                ppoly.ppoly_eval_backward_cuda(x, c, q, g),
                ppoly.ppoly_eval_second_order_cuda(x, c, q, g, u, V))
        return outs, [total(n, index) - b for n, b in zip(names, before)]
    _, grew = launch_all()
    assert grew == [1, 1, 2, 0]
    with profile(activities=[ProfilerActivity.CPU]):
        (out, (dq, dc), (d_c, d_q, d_g)), grew = launch_all()
    assert grew[:3] == [1, 1, 2]
    assert grew[3] == nbytes(x, c, q, out) + nbytes(x, c, q, g, dq, dc) + \
        nbytes(x, c, q, g, u, V, d_c, d_q, d_g)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize('clamp', [True, False])
def test_kernel_matches_plain_on_card(cuda_device, dtype, tol, clamp):
    rng = np.random.default_rng(11)
    x = _knots(rng, 31)
    c = _coeffs(x, rng.standard_normal((16, 31)))
    q = _queries(rng, x, (16, 3000))
    args = [torch.as_tensor(a, device=cuda_device).to(dtype)
            for a in (x, c, q)]
    before = total('ppoly.launches')
    got = ppoly.ppoly_eval_cuda(*args, clamp)
    assert total('ppoly.launches') == before + 1
    want = ppoly.ppoly_eval_plain(*args, clamp)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    fin = torch.isfinite(want)
    scale = float(want[fin].abs().max())
    assert float((got - want)[fin].abs().max()) <= tol * scale
    with pytest.raises(RuntimeError, match='no backward'):
        ppoly.ppoly_eval_cuda(args[0], args[1].requires_grad_(), args[2])


@pytest.mark.cuda
def test_cuda_tensors_launch_the_kernel_through_ops(cuda_device):
    """ops.splines on CUDA tensors: ppoly_eval with shared and per-row
    tables and Bicubic2D.ev each launch the kernel, and agree with the same
    calls on the CPU."""
    rng = np.random.default_rng(12)
    x = _knots(rng, 25)
    c = _coeffs(x, rng.standard_normal((4, 25)))
    q = _queries(rng, x, (4, 7, 30))
    r = np.sort(rng.uniform(1.0, 120.0, 25))
    mu = np.linspace(0.0, 1.0, 21)
    z = sum(np.outer(np.sin(r / (10.0 + 7 * k)), mu ** k) for k in range(3))
    surf = tsp.Bicubic2D.build(r, mu, z, device='cpu')
    p = rng.uniform(0.0, 1.0, q.shape)
    calls = [lambda dev, s: tsp.ppoly_eval(_t(x).to(dev), _t(c).to(dev),
                                           _t(q).to(dev)),
             lambda dev, s: tsp.ppoly_eval(_t(x).to(dev), _t(c[0]).to(dev),
                                           _t(q).to(dev), clamp=False),
             lambda dev, s: s.ev(_t(q).to(dev), _t(p).to(dev))]
    gpu_surf = surf.to(cuda_device, torch.float64)
    assert not surf.y_const
    for call, launches in zip(calls, (1, 1, 2 * surf.cu.shape[0])):
        before = total('ppoly.launches')
        got = call(cuda_device, gpu_surf)
        assert total('ppoly.launches') == before + launches
        want = call('cpu', surf)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                                   atol=1e-12, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize('K', [2, 3, 4])
@pytest.mark.parametrize('shared', [False, True])
def test_multi_channel_kernel_matches_plain_on_card(cuda_device, dtype, tol,
                                                    K, shared):
    """K channels over one query set against the plain version, NaN and inf
    positions identical; channel k equals the 1-channel kernel on table k
    bit for bit."""
    rng = np.random.default_rng(15 + K)
    x = _knots(rng, 30)
    c = _coeffs(x, rng.standard_normal((1 if shared else 16, K, 30)))
    q = _queries(rng, x, (16, 3000))
    args = [torch.as_tensor(a, device=cuda_device).to(dtype).contiguous()
            for a in (x, c, q)]
    before = (total('ppoly.launches'), total('ppoly.launches_multi'))
    got = ppoly.ppoly_eval_cuda(*args)
    assert (total('ppoly.launches'), total('ppoly.launches_multi')) == \
        (before[0] + 1, before[1] + 1)
    want = ppoly.ppoly_eval_plain(*args)
    torch.cuda.synchronize()
    assert got.shape == (16, K, 3000)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    scale = float(want[fin].abs().max())
    assert float((got - want)[fin].abs().max()) <= tol * scale
    for k in range(K):
        one = ppoly.ppoly_eval_cuda(args[0], args[1][:, k].contiguous(),
                                    args[2])
        assert torch.equal(torch.nan_to_num(one), torch.nan_to_num(got[:, k]))


@pytest.mark.cuda
def test_multi_channel_kernel_refuses_what_it_cannot_take(cuda_device):
    """More than four channels, or more shared memory than a block takes."""
    x = torch.linspace(0.0, 1.0, 400, dtype=torch.float64, device=cuda_device)
    q = torch.rand(2, 10, dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError, match='channels'):
        ppoly.ppoly_eval_cuda(x[:30], torch.zeros(2, 5, 29, 4, dtype=x.dtype,
                                                  device=cuda_device), q)
    with pytest.raises(ValueError, match='shared memory'):
        ppoly.ppoly_eval_cuda(x, torch.zeros(2, 4, 399, 4, dtype=x.dtype,
                                             device=cuda_device), q)
    three = torch.zeros(2, 3, 399, 4, dtype=x.dtype, device=cuda_device)
    assert ppoly.ppoly_eval_cuda(x, three, q).shape == (2, 3, 10)


def _edge_inputs(rng, B, M, n, K, shared, offset):
    """Knots sorted over [0.01, 120], random coefficients scaled by the
    interval width (c_j ~ h^-j, values of order one), and queries from 10%
    beyond both ends with every knot, NaN, +inf and -inf planted at the
    front (as many as fit) and at the end, laid `offset` elements into
    their storage."""
    x = np.concatenate([[0.01], np.sort(rng.uniform(2.0, 120.0, n - 1))])
    h = np.diff(x)[:, None] ** -np.arange(4.0)
    c = rng.standard_normal((1 if shared else B, K, n - 1, 4)) * h
    span = x[-1] - x[0]
    base = rng.uniform(x[0] - 0.1 * span, x[-1] + 0.1 * span, B * M + offset)
    flat = base[offset:]
    special = np.concatenate([x, [np.nan, np.inf, -np.inf]])
    k = min(len(special), flat.size)
    flat[:k] = special[:k]
    if flat.size > 2 * len(special):
        flat[-3:] = special[-3:]
    return x, (c if K > 1 else c[:, 0]), base


# (B, M, knots, channels, shared table, storage offset of q)
EDGE_SHAPES = [
    (16, 3000, 31, 1, False, 1),        # q one element into its storage
    (16, 3000, 30, 4, False, 1),
    (16, 3001, 31, 1, False, 0),        # odd M
    (16, 3001, 31, 2, False, 0),
    (16, 1, 31, 1, False, 0),           # M = 1
    (16, 3, 31, 1, False, 0),           # M under the vector width
    (1, 9_600_000, 25, 1, True, 0),     # one shared table, 9.6M queries
    (8, 49, 31, 1, False, 0),           # the Chebyshev-node lookups
    (8, 49, 31, 3, False, 0),
    (16, 64, 31, 1, False, 0),          # a short row on the vector path
    (16, 65, 31, 2, True, 0),           # a short odd row, shared table
    (1, 392, 25, 1, True, 0),
    (16, 3000, 2, 1, False, 0),         # n = 2
    (16, 3000, 1024, 1, False, 0),      # n = 1024
    (16, 3000, 30, 1, False, 0),        # K = 1..4
    (16, 3000, 30, 2, True, 0),
    (16, 3000, 30, 3, False, 0),
    (16, 3000, 30, 4, True, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize('B,M,n,K,shared,offset', EDGE_SHAPES)
@pytest.mark.parametrize('clamp', [True, False])
def test_kernel_edge_shapes_match_plain_on_card(cuda_device, dtype, tol, B,
                                                M, n, K, shared, offset,
                                                clamp):
    """The launch plan's other paths (scalar loads for an offset q or an
    odd M, rows shorter than a tile, a single-block call) and the table
    sizes at both ends, against the plain version with NaN and inf positions
    identical; each channel equals the 1-channel kernel on its table, and
    an offset q its aligned copy, bit for bit."""
    rng = np.random.default_rng(B + M + n + K + offset)
    x_np, c_np, base_np = _edge_inputs(rng, B, M, n, K, shared, offset)
    x, c, base = (torch.as_tensor(a, device=cuda_device).to(dtype)
                  for a in (x_np, c_np, base_np))
    q = base[offset:].view(B, M)
    assert q.storage_offset() == offset
    before = total('ppoly.launches')
    got = ppoly.ppoly_eval_cuda(x, c, q, clamp)
    assert total('ppoly.launches') == before + 1
    want = ppoly.ppoly_eval_plain(x, c, q, clamp)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    scale = float(want[fin].abs().max())
    assert float((got - want)[fin].abs().max()) <= tol * scale
    for k in range(K if K > 1 else 0):
        one = ppoly.ppoly_eval_cuda(x, c[:, k].contiguous(), q, clamp)
        assert torch.equal(torch.nan_to_num(one), torch.nan_to_num(got[:, k]))
    if offset:
        aligned = ppoly.ppoly_eval_cuda(x, c, q.clone(), clamp)
        assert torch.equal(torch.nan_to_num(aligned), torch.nan_to_num(got))


def _abs_terms(x, c, q, g, clamp):
    """The coefficient gradient's scale, in f64: the sum over each table
    entry's queries of |g| (1, |t|, t^2, |t|^3)."""
    x, q, g = x.double(), q.double(), g.double().abs()
    n = x.shape[0]
    qq = torch.clamp(q, x[0], x[-1]) if clamp else q
    idx = torch.clamp(torch.searchsorted(x, qq, right=True) - 1, 0, n - 2)
    t = (qq - x[idx]).abs()[:, None]
    g = g if c.ndim == 4 else g[:, None]                  # (B, K, M)
    B, K, M = g.shape
    terms = torch.stack([g, g * t, g * t * t, g * t * t * t], -1)
    rows = c.shape[0]
    table = (torch.arange(B, device=q.device)[:, None] % rows) * K + \
        torch.arange(K, device=q.device)
    flat = table[:, :, None] * (n - 1) + idx[:, None, :]
    out = torch.zeros(rows * K * (n - 1), 4, dtype=torch.float64,
                      device=q.device)
    out.index_add_(0, flat.reshape(-1), terms.reshape(-1, 4))
    return out.reshape(c.shape)


def _check_grads(got, want, scale_dq, scale_dc, tol):
    """dq within tol x max|dq|, dcoeffs within tol x the sum of its terms'
    magnitudes, element by element; NaN and inf positions identical."""
    for g, w, scale in ((got[0], want[0], scale_dq), (got[1], want[1],
                                                      scale_dc)):
        g, w = g.double(), w.double()
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        assert torch.equal(torch.isinf(g), torch.isinf(w))
        fin = torch.isfinite(w)
        bound = tol * (scale[fin] if torch.is_tensor(scale) else scale)
        assert bool(((g - w)[fin].abs() <= bound).all()), \
            float(((g - w)[fin].abs() - bound).max())


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize('B,M,n,K,shared,offset', EDGE_SHAPES + [
    (8, 150_000, 25, 1, True, 0),       # the HMC path's sigma_v lookup
    (8, 150_000, 31, 1, False, 0),      # its v_r and xi_0 lookups
    (8, 150_000, 30, 2, False, 0)])
@pytest.mark.parametrize('clamp', [True, False])
def test_backward_kernel_matches_plain_on_card(cuda_device, dtype, tol, B, M,
                                               n, K, shared, offset, clamp):
    """The backward kernel against its plain version at the forward's edge
    shapes and the HMC path's: dq and dcoeffs, NaN and inf positions
    identical, the f32 kernel held to the plain version in f64; two calls
    give the same bits (no atomics), and dq-only and dcoeffs-only calls the
    same values as a full one."""
    rng = np.random.default_rng(3 * B + M + n + K + offset)
    x_np, c_np, base_np = _edge_inputs(rng, B, M, n, K, shared, offset)
    g_np = rng.standard_normal((B, K, M) if K > 1 else (B, M))
    x, c, base, g = (torch.as_tensor(a, device=cuda_device).to(dtype)
                     for a in (x_np, c_np, base_np, g_np))
    q = base[offset:].view(B, M)
    before = total('ppoly.bwd_launches')
    got = ppoly.ppoly_eval_backward_cuda(x, c, q, g, clamp)
    again = ppoly.ppoly_eval_backward_cuda(x, c, q, g, clamp)
    dq_only = ppoly.ppoly_eval_backward_cuda(x, c, q, g, clamp,
                                             want_dcoeffs=False)
    dc_only = ppoly.ppoly_eval_backward_cuda(x, c, q, g, clamp, want_dq=False)
    assert total('ppoly.bwd_launches') == before + 4
    assert dq_only[1] is None and dc_only[0] is None
    want = ppoly.ppoly_eval_backward_plain(
        *(a.double() for a in (x, c, q, g)), clamp)
    torch.cuda.synchronize()
    assert got[0].shape == q.shape and got[1].shape == c.shape
    fin = torch.isfinite(want[0])
    _check_grads(got, want, float(want[0][fin].abs().max()),
                 _abs_terms(x, c, q, g, clamp), tol)
    for a, b in ((got[0], again[0]), (got[1], again[1]), (got[0], dq_only[0]),
                 (got[1], dc_only[1])):
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


# query patterns that stress the backward's reduction: (B, M, knots, one
# shared table, pattern)
BWD_PATTERNS = [
    (8, 150_000, 30, False, 'one'),         # every query in one interval
    (8, 150_000, 30, False, 'alternate'),   # intervals alternating
    (8, 150_000, 30, False, 'sorted'),      # long sorted runs
    (1, 9_600_000, 25, False, 'random'),    # B = 1, one very long row
    (64, 150_000, 30, True, 'random'),      # one table read by 64 rows
]


def _pattern_inputs(rng, B, M, n, shared, pattern):
    """`_edge_inputs` (one channel) with the queries of `pattern`: uniform
    within interval n // 3 ('one'), alternating between intervals 3 and
    n - 5 ('alternate'), sorted over [x[0], x[n-1]] along each row
    ('sorted') or `_edge_inputs`' own ('random'); NaN, +inf and -inf as
    each row's last three."""
    x, c, base = _edge_inputs(rng, B, M, n, 1, shared, 0)
    q = base.reshape(B, M)
    if pattern == 'random':
        return x, c, q
    u = rng.uniform(0.0, 1.0, (B, M))
    if pattern == 'sorted':
        q = x[0] + (x[-1] - x[0]) * np.sort(u, 1)
    else:
        iv = np.full(M, n // 3) if pattern == 'one' else \
            np.where(np.arange(M) % 2 == 0, 3, n - 5)
        q = x[iv] + u * (x[iv + 1] - x[iv])
    q[:, -3:] = [np.nan, np.inf, -np.inf]
    return x, c, q


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize('B,M,n,shared,pattern', BWD_PATTERNS)
def test_backward_kernel_query_patterns_on_card(cuda_device, dtype, tol, B, M,
                                                n, shared, pattern):
    """The backward kernel against its plain version where its reduction
    works hardest: a whole warp in one interval, neighbours in alternating
    intervals, long sorted runs, one very long row (hundreds of chunks into
    one table) and one table read by 64 rows; NaN and inf positions
    identical, and two calls give the same bits."""
    rng = np.random.default_rng(B + M + n)
    x_np, c_np, q_np = _pattern_inputs(rng, B, M, n, shared, pattern)
    g_np = rng.standard_normal((B, M))
    x, c, q, g = (torch.as_tensor(a, device=cuda_device).to(dtype)
                  for a in (x_np, c_np, q_np, g_np))
    got = ppoly.ppoly_eval_backward_cuda(x, c, q, g)
    again = ppoly.ppoly_eval_backward_cuda(x, c, q, g)
    want = ppoly.ppoly_eval_backward_plain(*(a.double() for a in (x, c, q, g)))
    torch.cuda.synchronize()
    fin = torch.isfinite(want[0])
    _check_grads(got, want, float(want[0][fin].abs().max()),
                 _abs_terms(x, c, q, g, True), tol)
    for a, b in zip(got, again):
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


@pytest.mark.cuda
def test_autograd_runs_the_backward_kernel_through_ops(cuda_device):
    """ops.splines on CUDA tensors that require grad: ppoly_eval with
    per-row and shared tables, ppoly_eval_multi and Bicubic2D.ev each
    launch the backward kernel once per lookup, and their gradients agree
    with the same calls on the CPU (the plain backward)."""
    rng = np.random.default_rng(21)
    x = _knots(rng, 25)
    c = _coeffs(x, rng.standard_normal((4, 25)))
    cm = _coeffs(x, rng.standard_normal((4, 2, 25)))
    q = _queries(rng, x, (4, 7, 30))
    q[~np.isfinite(q)] = 50.0
    r = np.sort(rng.uniform(1.0, 120.0, 25))
    mu = np.linspace(0.0, 1.0, 21)
    z = sum(np.outer(np.sin(r / (10.0 + 7 * k)), mu ** k) for k in range(3))
    surf = tsp.Bicubic2D.build(r, mu, z, device='cpu')
    p = rng.uniform(0.0, 1.0, q.shape)
    calls = [lambda dev, s, qq, cc: tsp.ppoly_eval(_t(x).to(dev), cc, qq),
             lambda dev, s, qq, cc: tsp.ppoly_eval(_t(x).to(dev), cc[0], qq,
                                                   clamp=False),
             lambda dev, s, qq, cc: tsp.ppoly_eval_multi(
                 _t(x).to(dev), _t(cm).to(dev), qq.reshape(4, -1)),
             lambda dev, s, qq, cc: s.ev(qq, _t(p).to(dev))]
    gpu_surf = surf.to(cuda_device, torch.float64)
    # Bicubic2D.ev: one lookup in q per rank takes a gradient, none in p
    for call, lookups in zip(calls, (1, 1, 1, surf.cu.shape[0])):
        grads = {}
        for dev, s in ((cuda_device, gpu_surf), ('cpu', surf)):
            qq = _t(q).to(dev).requires_grad_()
            cc = _t(c).to(dev).requires_grad_()
            out = call(dev, s, qq, cc)
            weight = torch.sin(torch.arange(out.numel(), dtype=out.dtype,
                                            device=dev)).reshape(out.shape)
            before = total('ppoly.bwd_launches')
            (out * weight).sum().backward()
            grads[str(dev)] = [qq.grad] + ([cc.grad] if cc.grad is not None
                                           else [])
            if dev != 'cpu':
                assert total('ppoly.bwd_launches') == before + lookups
        for got, want in zip(grads[str(cuda_device)], grads['cpu']):
            np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                       rtol=0, atol=1e-12 * float(
                                           want.abs().max()), equal_nan=True)


def _second_order_plain(x, c, q, g, u, V, clamp):
    """The second-order terms' plain version, in f64: autograd with
    create_graph through ppoly_eval_backward_plain (the gradient of
    <u, dq> + <V, dcoeffs> to (coeffs, q, grad_out)), with the port's rule
    at an infinite query without clamp (d/dq and d/dgrad_out NaN)."""
    with torch.enable_grad():
        leaves = [a.double().requires_grad_() for a in (c, q, g)]
        dq, dc = ppoly.ppoly_eval_backward_plain(x.double(), *leaves, clamp)
        s = (dq * u.double()).sum() + (dc * V.double()).sum()
        out = torch.autograd.grad(s, leaves, allow_unused=True)
    out = [torch.zeros_like(a) if d is None else d
           for d, a in zip(out, leaves)]
    if not clamp:
        inf = torch.isinf(q)
        out[1] = torch.where(inf, np.nan, out[1])
        out[2] = torch.where(inf if g.ndim == 2 else inf[:, None], np.nan,
                             out[2])
    return out


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize('B,M,n,K,shared,offset', [
    (16, 3000, 30, 4, False, 1), (16, 3001, 31, 1, False, 0),
    (16, 3, 31, 1, False, 0), (8, 49, 31, 3, False, 0),
    (16, 65, 31, 2, True, 0), (16, 3000, 2, 1, False, 0),
    (16, 3000, 1024, 1, False, 0),
    (1, 600_000, 25, 1, True, 0),       # a Hessian's sigma_v lookup
    (4, 150_000, 31, 1, False, 0),      # its v_r and xi_0 lookups
    (4, 150_000, 30, 2, False, 0)])
@pytest.mark.parametrize('clamp', [True, False])
def test_second_order_matches_plain_on_card(cuda_device, dtype, tol, B, M, n,
                                            K, shared, offset, clamp):
    """ppoly_eval_second_order on the card (the fused kernel: two launches
    with d/dcoeffs) against autograd through the plain backward in f64: NaN
    and inf positions identical, d/dq and d/dgrad_out within tol x their
    largest entry, d/dcoeffs within tol x the summed magnitudes of its
    terms; two calls give the same bits."""
    rng = np.random.default_rng(5 * B + M + n + K + offset)
    x_np, c_np, base_np = _edge_inputs(rng, B, M, n, K, shared, offset)
    g_np = rng.standard_normal((B, K, M) if K > 1 else (B, M))
    x, c, base, g, u, V = (
        torch.as_tensor(a, device=cuda_device).to(dtype)
        for a in (x_np, c_np, base_np, g_np, rng.standard_normal((B, M)),
                  rng.standard_normal(c_np.shape)))
    q = base[offset:].view(B, M)
    before = total('ppoly.second_order_launches')
    got = ppoly.ppoly_eval_second_order(x, c, q, g, u, V, clamp)
    again = ppoly.ppoly_eval_second_order(x, c, q, g, u, V, clamp)
    assert total('ppoly.second_order_launches') == before + 4
    want = _second_order_plain(x, c, q, g, u, V, clamp)
    torch.cuda.synchronize()
    cq = ppoly.clip_factor(x.double(), q.double()) if clamp else 1.0
    w = (u.double() * cq).abs()
    A = _abs_terms(x, c, q, (w[:, None] if K > 1 else w) * g.double().abs(),
                   clamp)
    scale_c = torch.stack([torch.zeros_like(A[..., 0]), A[..., 0],
                           2.0 * A[..., 1], 3.0 * A[..., 2]], -1)
    for k, p, scale in zip(got, want, (scale_c, None, None)):
        k = k.double()
        assert torch.equal(torch.isnan(k), torch.isnan(p))
        assert torch.equal(torch.isinf(k), torch.isinf(p))
        fin = torch.isfinite(p)
        bound = tol * (scale[fin] if scale is not None else
                       float(p[fin].abs().max()))
        assert bool(((k - p)[fin].abs() <= bound).all())
    for a, b in zip(got, again):
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('B,M,n,K,shared,offset', [
    (16, 3000, 30, 4, False, 1), (16, 3001, 31, 1, False, 0),
    (16, 3, 31, 1, False, 0), (8, 49, 31, 3, False, 0),
    (16, 65, 31, 2, True, 0), (16, 3000, 2, 1, False, 0),
    (16, 3000, 1024, 1, False, 0),
    (1, 600_000, 25, 1, True, 0),       # a Hessian's sigma_v lookup
    (4, 150_000, 31, 1, False, 0),      # its v_r and xi_0 lookups
    (4, 150_000, 30, 2, False, 0)])
@pytest.mark.parametrize('clamp', [True, False])
def test_second_order_fused_equals_composed_on_card(cuda_device, dtype, B, M,
                                                    n, K, shared, offset,
                                                    clamp):
    """The fused second-order kernel against the composed path (the forward
    and backward kernels on derived tables) on the same inputs: every term
    equal bit for bit (NaN positions identical), with both cotangents, with
    u or V alone, and with a term not asked for; one launch, two with
    d/dcoeffs."""
    rng = np.random.default_rng(7 * B + M + n + K + offset)
    x_np, c_np, base_np = _edge_inputs(rng, B, M, n, K, shared, offset)
    g_np = rng.standard_normal((B, K, M) if K > 1 else (B, M))
    x, c, base, g, u, V = (
        torch.as_tensor(a, device=cuda_device).to(dtype)
        for a in (x_np, c_np, base_np, g_np, rng.standard_normal((B, M)),
                  rng.standard_normal(c_np.shape)))
    q = base[offset:].view(B, M)
    for uu, VV, wants in ((u, V, (True, True, True)),
                          (u, None, (True, True, False)),
                          (None, V, (False, True, True)),
                          (u, V, (False, True, True))):
        before = total('ppoly.second_order_launches')
        got = ppoly.ppoly_eval_second_order_cuda(x, c, q, g, uu, VV, clamp,
                                                 *wants)
        assert total('ppoly.second_order_launches') == \
            before + 1 + (wants[0] and uu is not None)
        want = ppoly.ppoly_eval_second_order_composed(x, c, q, g, uu, VV,
                                                      clamp, *wants)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.equal(torch.isnan(a), torch.isnan(b))
                assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


@pytest.mark.cuda
def test_second_derivatives_through_ops_launch_the_kernels(cuda_device):
    """A Hessian-vector product of a spline lookup through ops.splines on
    CUDA tensors (create_graph=True, then a second backward) launches the
    fused second-order kernel once with its reduce (the cotangent of dq
    reaches the queries and the coefficients, that of dcoeffs the queries:
    d/dcoeffs is wanted) and agrees
    with the same product on the CPU; a third order raises."""
    rng = np.random.default_rng(23)
    x = _knots(rng, 25)
    c = _coeffs(x, rng.standard_normal((4, 25)))
    q = _queries(rng, x, (4, 300))
    w, u, V = (rng.standard_normal(a) for a in (q.shape, q.shape, c.shape))
    results = {}
    for dev in (cuda_device, torch.device('cpu')):
        qq = _t(q).to(dev).requires_grad_()
        cc = _t(c).to(dev).requires_grad_()
        out = tsp.ppoly_eval(_t(x).to(dev), cc, qq)
        dq, dc = torch.autograd.grad((out * _t(w).to(dev)).sum(), (qq, cc),
                                     create_graph=True)
        s = (dq * _t(u).to(dev)).sum() + (dc * _t(V).to(dev)).sum()
        before = total('ppoly.second_order_launches')
        results[dev.type] = torch.autograd.grad(s, (qq, cc),
                                                retain_graph=True)
        if dev.type == 'cuda':
            assert total('ppoly.second_order_launches') == before + 2
            with pytest.raises(RuntimeError, match='third'):
                torch.autograd.grad(s, qq, create_graph=True)
    for got, want in zip(results['cuda'], results['cpu']):
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                                   atol=1e-12 * float(want[
                                       torch.isfinite(want)].abs().max()),
                                   equal_nan=True)


@pytest.mark.cuda
def test_kernel_offsets_past_two_to_the_31(cuda_device):
    """B * M > 2^31 (an unchunked batch of 14,400 parameter points at BOSS
    size): the last rows, whose offsets need 64 bits, match the plain
    version. f32 keeps q and out at 8.6 GB each."""
    B, M = 14_400, 150_000
    assert B * M > 2 ** 31
    rng = np.random.default_rng(13)
    x_np = _knots(rng, 31)
    x = torch.as_tensor(x_np, device=cuda_device, dtype=torch.float32)
    c = torch.as_tensor(_coeffs(x_np, rng.standard_normal((B, 31))),
                        device=cuda_device, dtype=torch.float32)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    q = torch.rand((B, M), generator=gen, device=cuda_device)
    q.mul_(130.0).sub_(5.0)
    out = ppoly.ppoly_eval_cuda(x, c, q)
    tail = slice(B - 8, B)
    want = ppoly.ppoly_eval_plain(x, c[tail].contiguous(), q[tail].contiguous())
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    assert float((out[tail] - want).abs().max()) <= 1e-5 * scale
    head = ppoly.ppoly_eval_plain(x, c[:8].contiguous(), q[:8].contiguous())
    assert float((out[:8] - head).abs().max()) <= 1e-5 * scale
    del q, out
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize('shared', [False, True])
def test_dispersion_kernel_matches_plain_on_card(cuda_device, dtype, tol,
                                                 shared):
    rng = np.random.default_rng(19)
    args = [torch.as_tensor(a, device=cuda_device).to(dtype) for a in
            _dispersion_inputs(rng, 6, 10, 3000, rows=1 if shared else None)]
    before = total('dispersion.launches')
    got = dispersion.dispersion_final_cuda(*args)
    assert total('dispersion.launches') == before + 1
    want = dispersion.dispersion_final_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        assert torch.equal(torch.isinf(g), torch.isinf(w))
        fin = torch.isfinite(w)
        scale = float(w[fin].abs().max())
        assert float((g - w)[fin].abs().max()) <= tol * scale
    with pytest.raises(RuntimeError, match='no backward'):
        dispersion.dispersion_final_cuda(args[0], args[1].requires_grad_(),
                                         *args[2:])


@pytest.mark.cuda
def test_dispersion_cuda_tensors_launch_the_kernel_through_ops(cuda_device):
    """ops.splines.dispersion_final on CUDA tensors launches the kernel once
    and agrees with the same call on the CPU."""
    rng = np.random.default_rng(20)
    cpu = [_t(a) for a in _dispersion_inputs(rng, 3, 50, 300)]
    before = total('dispersion.launches')
    got = tsp.dispersion_final(*(a.to(cuda_device) for a in cpu))
    assert total('dispersion.launches') == before + 1
    want = tsp.dispersion_final(*cpu)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=0,
                                   atol=1e-12 * float(w[torch.isfinite(w)]
                                                      .abs().max()),
                                   equal_nan=True)


def _boss_config_npz():
    """configs/boss_config.yaml reading the .npz copies of its data files
    (data/BOSS_DR12_CMASS_npz), so that the test runs where h5py is
    absent."""
    import os

    import yaml
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, 'configs', 'boss_config.yaml')) as f:
        cfg = yaml.safe_load(f)

    def npz(path):
        stem = os.path.splitext(os.path.basename(path))[0]
        return os.path.join('data', 'BOSS_DR12_CMASS_npz', stem + '.npz')
    cfg['model']['input_model_data_file'] = npz(
        cfg['model']['input_model_data_file'])
    for block in ('redshift_space_ccf', 'covariance_matrix'):
        cfg['data'][block]['data_file'] = npz(cfg['data'][block]['data_file'])
    cfg['model']['dir'] = cfg['data']['dir'] = repo
    return cfg


@pytest.mark.cuda
def test_class_surface_on_the_card_launches_the_kernels(cuda_device):
    """CCFFit on the card: each exact theory call launches ppoly_eval three
    times (v_r, sigma_v, xi_0), dispersion_final='fused' launches
    dispersion_final once, and the values agree with the CPU port."""
    from victor_tpu_torch.api import CCFFit
    cfg = _boss_config_npz()
    cpu = CCFFit(cfg['model'], cfg['data'], device='cpu')
    card = CCFFit(cfg['model'], cfg['data'],
                  _bundle=cpu.bundle.to(cuda_device, torch.float64))
    golden = {'fsigma8': 0.47, 'beta': 0.37, 'sigma_v': 380.0,
              'epsilon': 1.0}
    fused = {'rsd_model': 'dispersion', 'dispersion_interior': 'exact',
             'dispersion_final': 'fused'}
    for kw in ({}, fused):
        before = (total('ppoly.launches'), total('dispersion.launches'))
        got = card.log_likelihood(golden, **kw)
        if not kw:
            assert total('ppoly.launches') == before[0] + 3
        assert total('dispersion.launches') == before[1] + bool(kw)
        want = cpu.log_likelihood(golden, **kw)
        np.testing.assert_allclose(got, want, rtol=1e-9)
    before = total('ppoly.launches')
    got = card.theory_multipoles(card.s, golden)
    assert total('ppoly.launches') == before + 3
    want = cpu.theory_multipoles(cpu.s, golden)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12)


@pytest.mark.cuda
def test_sharded_likelihood_on_the_card_launches_per_shard(cuda_device):
    """make_sharded_loglike over a 2-way mesh that names the card twice:
    3 ppoly_eval launches per shard, the values of the batched call on the
    card (1e-12) and of the CPU port (1e-9), and a gradient through the
    gather that launches the backward kernel 3 times per shard."""
    from victor_tpu_torch.io.tables import build_tables
    from victor_tpu_torch.likelihood.batched import (make_batched_loglike,
                                                     make_sharded_loglike)
    from victor_tpu_torch.parallel import make_mesh
    cfg = _boss_config_npz()
    names = ['fsigma8', 'beta', 'sigma_v', 'epsilon']
    exact = {'streaming_eval': 'exact', 'beta_covariance': 'exact'}
    rng = np.random.default_rng(23)
    theta = np.column_stack([
        rng.uniform(0.3, 0.6, 8), rng.uniform(0.25, 0.55, 8),
        rng.uniform(250.0, 450.0, 8), rng.uniform(0.9, 1.1, 8)])
    card = build_tables(cfg['model'], cfg['data'], n_mu=20, n_v=10,
                        device=cuda_device)
    cpu = build_tables(cfg['model'], cfg['data'], n_mu=20, n_v=10,
                       device='cpu')
    mesh = make_mesh(('walkers',), devices=[cuda_device] * 2)
    sharded = make_sharded_loglike(card, names, mesh, opts_kw=exact)
    before = total('ppoly.launches')
    got = sharded(theta)
    torch.cuda.synchronize()
    assert total('ppoly.launches') == before + 6
    want_card = make_batched_loglike(card, names, opts_kw=exact)(theta)
    want_cpu = make_batched_loglike(cpu, names, opts_kw=exact)(theta)
    for g, wc, wh in zip(got, want_card, want_cpu):
        assert g.device.type == 'cuda'
        np.testing.assert_allclose(g.cpu().numpy(), wc.cpu().numpy(),
                                   rtol=1e-12)
        np.testing.assert_allclose(g.cpu().numpy(), wh.numpy(), rtol=1e-9)
    t = torch.tensor(theta, device=cuda_device, requires_grad=True)
    before = total('ppoly.bwd_launches')
    g_sh, = torch.autograd.grad(make_sharded_loglike(
        card, names, mesh, gradient_free=False)(t)[0].sum(), t)
    torch.cuda.synchronize()
    assert total('ppoly.bwd_launches') == before + 6
    g_b, = torch.autograd.grad(make_batched_loglike(
        card, names, gradient_free=False)(t)[0].sum(), t)
    np.testing.assert_allclose(g_sh.cpu().numpy(), g_b.cpu().numpy(),
                               rtol=1e-10)


@pytest.mark.cuda
def test_sharded_joint_likelihood_across_cards(cuda_device, tmp_path):
    """make_sharded_joint_loglike over a mesh of every card, each a distinct
    device (skips with fewer than two): JointBundle.to replicates the two
    quantiles' tables and the joint covariance stack onto every card, each
    card launches ppoly_eval on its own slice, and the values and the
    gradient through the gather are those of the batched call on cuda:0
    (1e-12, 1e-10)."""
    import copy

    from victor_tpu_torch.io.loaders import load_key_value_file
    from victor_tpu_torch.likelihood.multiquantile import (
        build_joint_tables, make_batched_joint_loglike,
        make_sharded_joint_loglike)
    from victor_tpu_torch.parallel import make_mesh, replicate
    n_dev = torch.cuda.device_count()
    if n_dev < 2:
        pytest.skip('needs two CUDA devices or more')
    cfg = _boss_config_npz()
    data = cfg['data']
    cd = load_key_value_file(os.path.join(
        data['dir'], data['covariance_matrix']['data_file']))
    covs = np.asarray(cd['covmat'])
    n_b, D = covs.shape[:2]
    stack = np.zeros((n_b, 2 * D, 2 * D))
    stack[:, :D, :D] = stack[:, D:, D:] = covs
    cov_path = str(tmp_path / 'joint_cov.npz')
    np.savez(cov_path, covmat=stack, beta=np.asarray(cd['beta']))
    q = {'model': copy.deepcopy(cfg['model']),
         'data': {'redshift_space_ccf':
                  copy.deepcopy(data['redshift_space_ccf']),
                  'dir': data['dir']}}
    jb = build_joint_tables({
        'quantiles': [q, copy.deepcopy(q)],
        'covariance_matrix': {'data_file': cov_path, 'cov_key': 'covmat',
                              'fixed_beta': False, 'beta_key': 'beta'},
        'likelihood': copy.deepcopy(data['likelihood'])},
        device=cuda_device)
    names = ['fsigma8', 'beta', 'sigma_v', 'epsilon', 'sigma_v__q1']
    rng = np.random.default_rng(29)
    n = 8 * n_dev
    theta = np.column_stack([
        rng.uniform(0.3, 0.6, n), rng.uniform(0.25, 0.55, n),
        rng.uniform(250.0, 450.0, n), rng.uniform(0.9, 1.1, n),
        rng.uniform(300.0, 420.0, n)])
    mesh = make_mesh(('walkers',))
    cards = [torch.device('cuda', i) for i in range(n_dev)]
    replicas = replicate(jb, mesh)
    assert list(replicas) == cards
    for d, r in replicas.items():
        assert r.icov.device == d and r.cov_pencil.device == d
        assert all(b.tables.iaH.device == d for b in r.bundles)

    batched = make_batched_joint_loglike(jb, names)
    before = total('ppoly.launches')
    want = batched(theta)
    torch.cuda.synchronize()
    per_call = total('ppoly.launches') - before
    sharded = make_sharded_joint_loglike(jb, names, mesh)
    before = total('ppoly.launches')
    got = sharded(theta)
    for d in cards:
        torch.cuda.synchronize(d)
    assert total('ppoly.launches') - before == n_dev * per_call
    for g, w in zip(got, want):
        assert g.device == cards[0] and g.shape == (n,)
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=1e-12)

    t = torch.tensor(theta, device=cuda_device, requires_grad=True)
    g_sh, = torch.autograd.grad(make_sharded_joint_loglike(
        jb, names, mesh, gradient_free=False)(t)[0].sum(), t)
    g_b, = torch.autograd.grad(make_batched_joint_loglike(
        jb, names, gradient_free=False)(t)[0].sum(), t)
    np.testing.assert_allclose(g_sh.cpu().numpy(), g_b.cpu().numpy(),
                               rtol=1e-10)


def _bits(t):
    """The bit patterns of a float tensor, NaN entries zeroed (their
    payloads are not compared), and the NaN mask."""
    nan = torch.isnan(t)
    ints = t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)
    return torch.where(nan, torch.zeros_like(ints), ints), nan


def _plain_series(series, q):
    """`chebyshev_eval_cuda`'s signature on the plain recurrence."""
    return tuple(chebyshev.chebyshev_eval_plain(*s, q) for s in series)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('S', [1, 2])
@pytest.mark.parametrize('K', [17, 25, 49])
@pytest.mark.parametrize('tail,offset', [((3000,), 0), ((50, 3000), 0),
                                         ((7, 41), 0), ((3000,), 1)])
def test_chebyshev_kernel_equals_plain_on_card(cuda_device, dtype, S, K, tail,
                                               offset):
    """The Clenshaw kernel against the plain recurrence on the card, bit
    for bit (equal NaN masks, every other entry's bits equal, the sign of
    a zero included): (B, q) and (B, 50, 3000) queries, an odd row length
    (7 x 41, the scalar path) and q at a storage offset of one element (not
    aligned to a pair), with queries beyond both ends of the domain, at its
    end points, NaN and infinite. Through ops.splines it is one launch."""
    rng = np.random.default_rng(60 + S + K)
    B = 16
    series, q = _chebyshev_inputs(rng, B, S, K, tail)
    series = _torch_series(series, dtype=dtype, device=cuda_device)
    q = torch.as_tensor(q, dtype=dtype, device=cuda_device)
    q2 = q.reshape(B, -1)
    if offset:
        q2 = torch.cat([q2.new_zeros(1), q2.reshape(-1)])[1:].view(q2.shape)
        assert q2.data_ptr() % (2 * q2.element_size()) != 0
    got = chebyshev.chebyshev_eval_cuda(series, q2)
    want = _plain_series(series, q2)
    torch.cuda.synchronize()
    assert len(got) == len(want) == S
    for g, w in zip(got, want):
        assert g.shape == w.shape == (B, q2.shape[1])
        (gb, gn), (wb, wn) = _bits(g), _bits(w)
        assert torch.equal(gn, wn) and int(gn.sum()) == B
        assert torch.equal(gb, wb)
    before = total('chebyshev.launches')
    via_ops = tsp.chebyshev_eval_multi(series, q)
    assert total('chebyshev.launches') == before + 1
    for v, w in zip(via_ops, want):
        assert v.shape == (B,) + tail
        assert torch.equal(_bits(v.reshape(B, -1))[0], _bits(w)[0])


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('K', [17, 25, 49])
@pytest.mark.parametrize('tail', [(3000,), (50, 3000), (7, 41)])
def test_chebyshev_transpose_kernel_matches_plain_on_card(cuda_device, dtype,
                                                          K, tail):
    """The transpose kernel (sum_m g T_k(u) per row) against the plain
    version on the card: within 1e-12 (f64) or 1e-5 (f32) of each row's
    sum |g| (|T_k| <= 1), NaN where the plain version has it (every term
    but T_0 = 1 of the odd rows, which hold a NaN query; the even ones have
    it replaced by a finite query), and the same bits on a second launch
    (no atomics)."""
    rng = np.random.default_rng(75 + K + len(tail))
    B = 16
    series, q = _chebyshev_inputs(rng, B, 1, K, tail)
    q = q.reshape(B, -1)
    q[0::2] = np.nan_to_num(q[0::2], nan=50.0, posinf=np.inf,
                            neginf=-np.inf)
    _, a, b = _torch_series(series, dtype=dtype, device=cuda_device)[0]
    q = torch.as_tensor(q, dtype=dtype, device=cuda_device)
    g = torch.as_tensor(rng.standard_normal(q.shape), dtype=dtype,
                        device=cuda_device)
    before = total('chebyshev.transpose_launches')
    got = chebyshev.chebyshev_transpose_cuda(g, a, b, q, K)
    again = chebyshev.chebyshev_transpose_cuda(g, a, b, q, K)
    assert total('chebyshev.transpose_launches') == before + 2
    want = chebyshev.chebyshev_transpose_plain(g, a, b, q, K)
    assert got.shape == (B, K)
    assert torch.equal(_bits(got)[0], _bits(again)[0])
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert bool(torch.isnan(got[1::2, 1:]).all())
    tol = (1e-12 if dtype == torch.float64 else 1e-5) * g.abs().sum(1)
    err = (got - want).nan_to_num(0.0).abs().max(1).values
    assert bool((err <= tol).all()), (err, tol)


@pytest.mark.cuda
@pytest.mark.parametrize('S', [1, 2])
def test_chebyshev_gradient_on_card_runs_the_kernels(cuda_device, S):
    """Under a recorded gradient a CUDA call goes through ChebyshevEval:
    the forward and the derivative's series on the evaluation kernel, the
    coefficients' gradient on the transpose kernel, and no plain CUDA
    call. Its gradient and a Hessian-vector product equal the CPU's
    (ChebyshevEval on the plain pieces, itself held to the plain autograd
    by test_chebyshev_gradient_equals_plain_autograd) within 1e-12 of each
    one's largest entry, NaN in the same places."""
    rng = np.random.default_rng(70 + S)
    series, q = _chebyshev_inputs(rng, 4, S, 49, (2, 300))
    weights = [rng.standard_normal(q.shape) for _ in range(S)]
    shapes = [q.shape] + [t.shape for s in series for t in s]
    probe = [rng.standard_normal(sh) for sh in shapes]

    def run(device):
        ser = _torch_series(series, dtype=torch.float64, device=device)
        leaves = [torch.as_tensor(q, device=device).requires_grad_()] + [
            t.requires_grad_() for s in ser for t in s]
        outs = tsp.chebyshev_eval_multi(
            [leaves[i:i + 3] for i in range(1, len(leaves), 3)], leaves[0])
        loss = sum((o * torch.as_tensor(w, device=device)).nansum()
                   for o, w in zip(outs, weights))
        grads = torch.autograd.grad(loss, leaves, create_graph=True)
        hvp = torch.autograd.grad(
            sum((gr * torch.as_tensor(p, device=device)).nansum()
                for gr, p in zip(grads, probe)), leaves, allow_unused=True)
        return [t.detach().cpu() for t in grads] + [
            torch.zeros(sh, dtype=torch.float64) if h is None else h.cpu()
            for h, sh in zip(hvp, shapes)]

    names = ('chebyshev.launches', 'chebyshev.transpose_launches',
             'chebyshev.plain_cuda')
    before = [total(n, cuda_device) for n in names]
    got = run(cuda_device)
    grew = [total(n, cuda_device) - c for n, c in zip(names, before)]
    assert grew[0] >= 2 and grew[1] >= S and grew[2] == 0, grew
    want = chebyshev_function_on_cpu(run)
    for g, w in zip(got, want):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        scale = float(w.nan_to_num(0.0).abs().max())
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-12 * max(scale, 1e-300))


def chebyshev_function_on_cpu(run):
    """`run('cpu')` with the CPU tensors routed through ChebyshevEval (the
    router sends them to the plain recurrence)."""
    real = tsp.chebyshev_eval_multi

    def through_function(series, q):
        flat = [t for s in series for t in s]
        q2 = q.reshape(q.shape[0], -1)
        outs = chebyshev.ChebyshevEval.apply(q2, *flat)
        return tuple(o.view(q.shape) for o in outs)
    tsp.chebyshev_eval_multi = through_function
    try:
        return run('cpu')
    finally:
        tsp.chebyshev_eval_multi = real


@pytest.mark.cuda
@pytest.mark.parametrize('order', [1, 2])
def test_dispersion_derivatives_run_the_kernels_on_card(cuda_device, order):
    """d lnL / d theta (order 1) and the Hessian by replicated rows (order
    2) of the dispersion model in its default modes (Chebyshev interior,
    'fast' final stage): the Clenshaw kernel and its transpose launch, and
    no CUDA tensor reaches the plain recurrence."""
    from victor_tpu_torch.io.tables import build_tables
    from victor_tpu_torch.sampling.optimize import value_grad_hessian
    from victor_tpu_torch.sampling.targets import resolve_target
    cfg = _boss_config_npz()
    bundle = build_tables(cfg['model'], cfg['data'], device=cuda_device)
    tables, loglike = resolve_target(bundle, {'rsd_model': 'dispersion'},
                                     None, gradient_free=False)
    names = ('fsigma8', 'beta', 'sigma_v', 'epsilon')
    th = torch.tensor([[0.47, 0.40, 380.0, 1.0], [0.40, 0.45, 330.0, 1.02]],
                      dtype=torch.float64, device=cuda_device)

    def neg(t):
        return -loglike(tables, {k: t[:, i] for i, k in enumerate(names)})[0]
    counters = ('chebyshev.launches', 'chebyshev.transpose_launches',
                'chebyshev.plain_cuda')
    before = [total(n) for n in counters]
    if order == 1:
        t = th.clone().requires_grad_()
        (out,) = torch.autograd.grad(neg(t).sum(), t)
    else:
        out = value_grad_hessian(neg, th)[2]
    torch.cuda.synchronize()
    grew = [total(n) - c for n, c in zip(counters, before)]
    assert bool(torch.isfinite(out).all())
    assert grew[0] > 0 and grew[1] > 0 and grew[2] == 0, grew


def _boss_fast_bundle(device):
    """The BOSS bundle (configs/boss_config.yaml, full width, f64) on
    `device`, and the gradient-free fast modes of the SMC path."""
    from victor_tpu_torch.io.tables import build_tables
    cfg = _boss_config_npz()
    return build_tables(cfg['model'], cfg['data'], device=device), {
        'streaming_eval': 'fast', 'beta_covariance': 'factored',
        'dispersion_final': 'fast'}


@pytest.mark.cuda
def test_boss_fast_chunk_equals_plain_recurrence_on_card(cuda_device,
                                                         monkeypatch):
    """One chunk of 64 BOSS parameter points in the fast streaming mode: the
    log-likelihoods with the Clenshaw kernel equal those with the plain
    recurrence on the card bit for bit, and the chunk launches the kernel
    once."""
    from victor_tpu_torch.likelihood.batched import make_batched_loglike
    bundle, fast = _boss_fast_bundle(cuda_device)
    rng = np.random.default_rng(71)
    theta = torch.as_tensor(np.column_stack([
        rng.uniform(0.3, 0.6, 64), rng.uniform(0.25, 0.55, 64),
        rng.uniform(250.0, 450.0, 64), rng.uniform(0.9, 1.1, 64)]),
        device=cuda_device)
    loglike = make_batched_loglike(bundle, ['fsigma8', 'beta', 'sigma_v',
                                            'epsilon'], opts_kw=fast, chunk=64)
    before = total('chebyshev.launches')
    lnl, chi2 = loglike(theta)
    torch.cuda.synchronize()
    assert total('chebyshev.launches') == before + 1
    monkeypatch.setattr(chebyshev, 'chebyshev_eval_cuda', _plain_series)
    lnl_p, chi2_p = loglike(theta)
    assert total('chebyshev.launches') == before + 1
    assert bool(torch.isfinite(lnl).all())
    for got, want in ((lnl, lnl_p), (chi2, chi2_p)):
        assert torch.equal(_bits(got)[0], _bits(want)[0])


@pytest.mark.cuda
def test_smc_stage_launches_the_kernel_once_per_chunk(cuda_device, tmp_path):
    """A fresh SMC stage in the fast modes (the initial evaluation and the
    moves, 256 particles in chunks of 64) counts exactly one
    `chebyshev.launches` per streaming chunk and no `chebyshev.plain_cuda`."""
    from victor_tpu_torch.sampling.smc import run_smc
    bundle, fast = _boss_fast_bundle(cuda_device)
    params = {name: {'prior': {'dist': 'uniform', 'min': lo, 'max': hi}}
              for name, lo, hi in (('fsigma8', 0.05, 1.5), ('beta', 0.2, 0.6),
                                   ('sigma_v', 100.0, 500.0),
                                   ('epsilon', 0.8, 1.2))}
    n, moves, chunk = 256, 2, 64
    names = ('chebyshev.launches', 'chebyshev.plain_cuda')
    before = [total(name) for name in names]
    try:
        run_smc(bundle, params, n_particles=n, n_moves=moves, seed=3,
                opts_kw=fast, chunk=chunk, max_stages=1,
                checkpoint=str(tmp_path / 'smc.npz'), device=cuda_device)
    except RuntimeError as e:
        assert 'did not reach beta=1' in str(e)
    torch.cuda.synchronize()
    grew = [total(name) - b for name, b in zip(names, before)]
    assert grew == [(1 + moves) * (n // chunk), 0]
