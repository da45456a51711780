"""The CUDA kernels' wrappers, their build and their plain versions:
ppoly_eval (one table or K channels over one query set) and the dispersion
model's final stage.

This module imports neither jax nor victor_tpu, so it also runs on a GPU
machine without them:

    python -m pytest --noconftest tests/test_torch_kernels.py

Tests marked `cuda` need a CUDA device and nvcc, and skip without a card.
The helpers here make the inputs of tests/test_torch_splines.py too.
"""

import numpy as np
import pytest
import torch

from victor_tpu_torch.kernels import _build, dispersion, ppoly
from victor_tpu_torch.ops import splines as tsp

torch.set_num_threads(1)


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
    before = ppoly.LAUNCHES
    got = tsp.ppoly_eval(_t(x), _t(c), _t(q))
    want = ppoly.ppoly_eval_plain(_t(x), _t(c), _t(q))
    assert ppoly.LAUNCHES == before
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize('shared', [False, True])
def test_multi_channel_cpu_tensors_take_the_plain_version(shared):
    rng = np.random.default_rng(14)
    x = _knots(rng, 30)
    c = _coeffs(x, rng.standard_normal((3, 30) if shared else (2, 3, 30)))
    q = _queries(rng, x, (2, 60))
    before = (ppoly.LAUNCHES, ppoly.LAUNCHES_MULTI)
    got = tsp.ppoly_eval_multi(_t(x), _t(c), _t(q))
    assert (ppoly.LAUNCHES, ppoly.LAUNCHES_MULTI) == before
    want = ppoly.ppoly_eval_plain(_t(x), _t(c if not shared else c[None]),
                                  _t(q))
    assert got.shape == (2, 3, 60)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_kernel_wrapper_refuses_cpu_tensors():
    x = torch.linspace(0.0, 1.0, 5, dtype=torch.float64)
    with pytest.raises(ValueError, match='CUDA'):
        ppoly.ppoly_eval_cuda(x, torch.zeros(1, 4, 4, dtype=torch.float64),
                              torch.zeros(2, 3, dtype=torch.float64))


@pytest.mark.parametrize('name', ['ppoly_eval', 'dispersion_final'])
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
    before = dispersion.LAUNCHES
    got = tsp.dispersion_final(*args)
    want = dispersion.dispersion_final_plain(*args)
    assert dispersion.LAUNCHES == before
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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: run on the GPU machine with '
                    '`python -m pytest --noconftest tests/test_torch_kernels.py`')
    return torch.device('cuda')


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
    before = ppoly.LAUNCHES
    got = ppoly.ppoly_eval_cuda(*args, clamp)
    assert ppoly.LAUNCHES == before + 1
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
    surf = tsp.Bicubic2D.build(r, mu, z)
    p = rng.uniform(0.0, 1.0, q.shape)
    calls = [lambda dev, s: tsp.ppoly_eval(_t(x).to(dev), _t(c).to(dev),
                                           _t(q).to(dev)),
             lambda dev, s: tsp.ppoly_eval(_t(x).to(dev), _t(c[0]).to(dev),
                                           _t(q).to(dev), clamp=False),
             lambda dev, s: s.ev(_t(q).to(dev), _t(p).to(dev))]
    gpu_surf = surf.to(cuda_device, torch.float64)
    assert not surf.y_const
    for call, launches in zip(calls, (1, 1, 2 * surf.cu.shape[0])):
        before = ppoly.LAUNCHES
        got = call(cuda_device, gpu_surf)
        assert ppoly.LAUNCHES == before + launches
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
    before = (ppoly.LAUNCHES, ppoly.LAUNCHES_MULTI)
    got = ppoly.ppoly_eval_cuda(*args)
    assert (ppoly.LAUNCHES, ppoly.LAUNCHES_MULTI) == (before[0] + 1,
                                                      before[1] + 1)
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
    before = dispersion.LAUNCHES
    got = dispersion.dispersion_final_cuda(*args)
    assert dispersion.LAUNCHES == before + 1
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
    before = dispersion.LAUNCHES
    got = tsp.dispersion_final(*(a.to(cuda_device) for a in cpu))
    assert dispersion.LAUNCHES == before + 1
    want = tsp.dispersion_final(*cpu)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=0,
                                   atol=1e-12 * float(w[torch.isfinite(w)]
                                                      .abs().max()),
                                   equal_nan=True)
