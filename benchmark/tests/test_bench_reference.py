"""The plain reference: its pieces against SciPy and NumPy, the whole
against the program at a small size on the CPU, and the whole-name scans
for what the harness and the reference import."""

import ast
import copy
import subprocess
import sys

import numpy as np
import pytest
import torch

import reference
from benchlib import drivers, manifest
from reference import streaming as st

FORBIDDEN = {'jax', 'jaxlib', 'flax', 'victor_tpu'}
#: the program's Delta(r) takes scipy's `quad` at its default tolerance
#: (the published fitting code's recipe); the reference integrates the
#: spline exactly. Their difference over the largest |Delta|, measured:
#: 2.04e-8.
DELTA_QUAD_REL = 5e-8


def _small():
    cfg = copy.deepcopy(manifest.find_cell('boss_smc').config)
    cfg.update(n_mu=20, n_v=10)
    return cfg


def _theta(cfg, n, seed):
    """Points over the whole prior box, where the slopes are largest."""
    g = torch.Generator().manual_seed(seed)
    lo = torch.tensor([p['prior']['min'] for p in cfg['params'].values()],
                      dtype=torch.float64)
    hi = torch.tensor([p['prior']['max'] for p in cfg['params'].values()],
                      dtype=torch.float64)
    return lo + (hi - lo) * torch.rand(n, len(lo), generator=g,
                                       dtype=torch.float64)


def _program(cfg):
    from victor_tpu_torch.io.tables import build_tables
    return build_tables(cfg['model'], cfg['data'], n_mu=cfg['n_mu'],
                        n_v=cfg['n_v'], device='cpu')


# -- the pieces ---------------------------------------------------------------

def test_not_a_knot_spline_is_scipys():
    from scipy.interpolate import (CubicSpline, InterpolatedUnivariateSpline,
                                   RectBivariateSpline)
    rng = np.random.default_rng(1)
    x = np.sort(rng.uniform(0, 120, 25))
    y = rng.normal(size=25)
    q = np.linspace(-5, 130, 1001)
    mine = st.spline_host(x, y, q)
    inside = (q >= x[0]) & (q <= x[-1])
    assert np.allclose(mine[inside], CubicSpline(x, y)(q[inside]),
                       rtol=0, atol=1e-12)
    assert np.allclose(mine, InterpolatedUnivariateSpline(x, y, k=3, ext=3)(q),
                       rtol=0, atol=1e-12)
    # a surface constant along its second axis, as FITPACK evaluates it
    surf = RectBivariateSpline(x, np.linspace(0, 1), np.outer(y, np.ones(50)))
    assert np.allclose(mine, surf.ev(q, np.full_like(q, 0.3)), rtol=0,
                       atol=1e-12)
    # the device version, per row and shared
    xt, yt = torch.tensor(x), torch.tensor(np.stack([y, 2 * y]))
    m = yt @ torch.tensor(st.not_a_knot_operator(x)).T
    out = st.spline_at(xt, yt, m, torch.tensor(q).expand(2, -1))
    assert torch.allclose(out, torch.tensor(np.stack([mine, 2 * mine])),
                          rtol=0, atol=1e-12)


def test_pchip_pieces_are_scipys():
    from scipy.interpolate import PchipInterpolator
    rng = np.random.default_rng(2)
    x = np.sort(rng.uniform(0.1, 0.7, 9))
    table = rng.normal(size=(9, 3, 4))
    q = np.linspace(0.05, 0.75, 41)
    out = st.pchip_at(torch.tensor(x), torch.tensor(st.pchip_pieces(x, table)),
                      torch.tensor(q))
    assert np.allclose(out.numpy(), PchipInterpolator(x, table)(q),
                       rtol=0, atol=1e-12)


def test_chebyshev_interpolant_is_numpys():
    f = np.cos
    coef = st.chebyshev_matrix(st.CHEB_DEGREE) @ f(np.cos(
        (2 * np.arange(49) + 1) * np.pi / 98))
    assert np.allclose(coef, np.polynomial.chebyshev.chebinterpolate(f, 48),
                       rtol=0, atol=1e-14)
    u = torch.linspace(-1, 1, 301, dtype=torch.float64)[None]
    assert np.allclose(st.chebyshev_sum(torch.tensor(coef)[None], u).numpy(),
                       np.polynomial.chebyshev.chebval(u.numpy(), coef),
                       rtol=0, atol=1e-13)


def test_quadrature_weights():
    """The velocity rule against scipy's Simpson (odd counts) and its two
    end-corrected halves (even counts); the trapezoid against numpy's."""
    from scipy.integrate import simpson
    rng = np.random.default_rng(3)
    for n in (49, 50):
        x = np.linspace(-6, 6, n)
        f = rng.normal(size=n)
        if n % 2:
            want = simpson(f, dx=x[1] - x[0])
        else:
            dx = x[1] - x[0]
            want = 0.5 * (simpson(f[:-1], dx=dx) + 0.5 * dx * (f[-2] + f[-1])
                          + 0.5 * dx * (f[0] + f[1]) + simpson(f[1:], dx=dx))
        assert np.isclose(st.simpson_avg_weights(n, x[1] - x[0]) @ f, want,
                          rtol=1e-14, atol=1e-14)
    mu = np.linspace(0, 1, 7)
    assert np.allclose(st.trapezoid_weights(mu) @ mu ** 2,
                       np.trapezoid(mu ** 2, mu))


def test_enclosed_density_is_the_exact_integral():
    from scipy.integrate import quad
    from scipy.interpolate import InterpolatedUnivariateSpline
    m = st._load(_small()['model']['input_model_data_file'])
    rd, de = m['rdelta'], m['delta']
    spl = InterpolatedUnivariateSpline(rd, de, k=3, ext=3)
    r = np.array([0.5 * rd[0], rd[0], 17.3, rd[-1], 1.1 * rd[-1]])
    tight = [quad(lambda x, ri=ri: 3 * spl(x) * x ** 2 / ri ** 3, 0, ri,
                  epsabs=1e-15, epsrel=1e-14, limit=500,
                  points=rd[rd < ri])[0] for ri in r]
    assert np.allclose(st.enclosed_density(rd, de, r), tight, rtol=1e-13,
                       atol=0)


# -- the whole against the program --------------------------------------------

@pytest.mark.parametrize('path', ['smc', 'hmc'])
def test_reference_matches_the_program(path):
    """With the program's Delta(r) put in, every other piece agrees to
    rounding; with its own, the reference differs by the program's
    quadrature tolerance alone."""
    from victor_tpu_torch.likelihood.batched import make_batched_loglike
    cfg = _small()
    prog = _program(cfg)
    ref = reference.build(cfg, 'cpu')
    delta_r, delta_p = ref.Delta_rv.numpy(), prog.tables.Delta_rv.numpy()
    assert np.abs(delta_r - delta_p).max() <= \
        DELTA_QUAD_REL * np.abs(delta_r).max()
    theta = _theta(cfg, 24, 3)
    lnl, chi2 = make_batched_loglike(prog, list(cfg['params']),
                                     opts_kw=cfg['modes'][path],
                                     gradient_free=False)(theta)
    lnl_r, _ = reference.loglike(ref, cfg, path, theta)
    assert (lnl - lnl_r).abs().max() < 1e-5
    ref.Delta_rv = prog.tables.Delta_rv.clone()
    lnl_r, chi2_r = reference.loglike(ref, cfg, path, theta)
    assert (lnl - lnl_r).abs().max() < 1e-10
    assert torch.allclose(chi2, chi2_r, rtol=1e-12, atol=0)


def test_reference_posterior_gradient_matches_the_program():
    from victor_tpu_torch.sampling.hmc import value_and_grad
    from victor_tpu_torch.sampling.priors import ParamSpace
    from victor_tpu_torch.sampling.runner import unbounded_logpost
    from victor_tpu_torch.sampling.targets import resolve_target
    cfg = _small()
    prog = _program(cfg)
    space = ParamSpace(cfg['params'])
    tables, loglike = resolve_target(prog, cfg['modes']['hmc'], None,
                                     gradient_free=False)
    y = space.to_unbounded(_theta(cfg, 6, 4))
    lnp, chi2, grad = value_and_grad(
        unbounded_logpost(space, loglike, tables))(y)
    ref_space = reference.UniformSpace(cfg['params'])
    ref = reference.build(cfg, 'cpu')
    _, _, grad_own = reference.logpost_and_grad(ref, cfg, 'hmc', ref_space, y)
    assert drivers._grad_gap(grad, grad_own) < 1e-6
    ref.Delta_rv = prog.tables.Delta_rv.clone()
    lnp_r, chi2_r, grad_r = reference.logpost_and_grad(ref, cfg, 'hmc',
                                                       ref_space, y)
    assert torch.allclose(ref_space.to_bounded(y), space.to_bounded(y),
                          rtol=1e-15, atol=0)
    assert (lnp - lnp_r).abs().max() < 1e-10
    assert torch.allclose(chi2[:, 0], chi2_r, rtol=1e-12, atol=0)
    assert drivers._grad_gap(grad, grad_r) < 1e-11


def test_the_reference_refuses_what_it_does_not_implement():
    cfg = _small()
    cfg['model']['rsd_model'] = 'dispersion'
    with pytest.raises(ValueError, match='does not know'):
        reference.build(cfg, 'cpu')


# -- imports -------------------------------------------------------------------

def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in manifest.BENCH_DIR.rglob('*.py'):
        tops = {name.split('.')[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    for path in (manifest.BENCH_DIR / 'reference').rglob('*.py'):
        tops = {name.split('.')[0] for name in _imports(path)}
        assert tops <= {'__future__', 'math', 'pathlib', 'typing', 'numpy',
                        'scipy', 'torch'}, (path, tops)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """What a run of the harness loads, compared by whole top-level name:
    the program's name begins with the JAX package's and is allowed."""
    code = (
        'import sys; sys.argv = ["run.py"]\n'
        'sys.path[:0] = [{root!r}, {bench!r}]\n'
        'import run, conftest\n'
        'import victor_tpu_torch\n'
        'run.run_cell(conftest.tiny_cell("boss_hmc"), 5, 0.1, trace=False,'
        ' device="cpu")\n'
        'print(run.forbidden_modules())\n'
        'sys.modules["victor_tpu.x"] = sys\n'
        'print(run.forbidden_modules())\n').format(
            root=str(manifest.ROOT), bench=str(manifest.BENCH_DIR))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=600,
                         cwd=manifest.BENCH_DIR / 'tests')
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split('\n')[-3:-1] == ['[]', "['victor_tpu']"]
