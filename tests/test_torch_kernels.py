"""The ppoly_eval CUDA kernel's wrapper, its build and its plain version.

This module imports neither jax nor victor_tpu, so it also runs on a GPU
machine without them:

    python -m pytest --noconftest tests/test_torch_kernels.py

Tests marked `cuda` need a CUDA device and nvcc, and skip without a card.
The helpers here make the inputs of tests/test_torch_splines.py too.
"""

import numpy as np
import pytest
import torch

from victor_tpu_torch.kernels import _build, ppoly
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


def test_kernel_wrapper_refuses_cpu_tensors():
    x = torch.linspace(0.0, 1.0, 5, dtype=torch.float64)
    with pytest.raises(ValueError, match='CUDA'):
        ppoly.ppoly_eval_cuda(x, torch.zeros(1, 4, 4, dtype=torch.float64),
                              torch.zeros(2, 3, dtype=torch.float64))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, 'which', lambda name: None)
    monkeypatch.setattr(_build, 'DEFAULT_NVCC', str(tmp_path / 'no-nvcc'))
    with pytest.raises(RuntimeError, match='nvcc not found'):
        _build.build('ppoly_eval', build_dir=tmp_path)


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
