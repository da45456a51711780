"""victor_tpu_torch.ops.splines and the ppoly_eval kernel's wrapper against
victor_tpu.ops.splines.

All inputs are made with numpy from a seed and fed to both packages in f64.
On the CPU `ppoly_eval` runs its plain PyTorch version; it is held against
the JAX 'gather' strategy (what JAX runs on a CPU) and against the Pallas
kernel `ppoly_eval_pallas` in interpret mode. The CUDA kernel's own tests
are in test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from victor_tpu.ops import splines as jsp
from victor_tpu_torch.ops import splines as tsp

from test_torch_kernels import _coeffs, _knots, _queries, _t

torch.set_num_threads(1)

# identical inputs and the same Horner order on both sides: only the
# rounding of separately-compiled code can differ
ATOL = 1e-13


@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('clamp', [True, False])
@pytest.mark.parametrize('batched', [False, True])
def test_ppoly_eval_matches_jax_gather(seed, clamp, batched):
    rng = np.random.default_rng(seed)
    n = (25, 30, 31)[seed % 3]
    x = _knots(rng, n)
    rows = 8 if batched else 1
    c = _coeffs(x, rng.standard_normal((rows, n)))
    q = _queries(rng, x, (rows, 640))
    got = tsp.ppoly_eval(_t(x), _t(c if batched else c[0]), _t(q), clamp).numpy()

    def one(ci, qi):
        return jsp.ppoly_eval(jnp.asarray(x), ci, qi, clamp=clamp,
                              strategy='gather')
    want = np.asarray(jax.vmap(one)(jnp.asarray(c), jnp.asarray(q)) if batched
                      else one(jnp.asarray(c[0]), jnp.asarray(q)))
    inf_q = np.isinf(q)
    if not clamp:
        # an infinite query without clamping: the gather strategy returns
        # the end polynomial at +-inf; the port (like the masksum and the
        # Pallas kernel) adds qq - qq = inf - inf and returns NaN
        assert np.all(np.isnan(got[inf_q]))
        got, want = got[~inf_q], want[~inf_q]
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, equal_nan=True)
    assert np.isnan(got).sum() == np.isnan(want).sum() > 0


@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('clamp', [True, False])
def test_ppoly_eval_matches_pallas_interpret(seed, clamp):
    rng = np.random.default_rng(10 + seed)
    x = _knots(rng, 31)
    c = _coeffs(x, rng.standard_normal(31))
    q = _queries(rng, x, (64, 256))          # Pallas needs (32k, 128m)
    got = tsp.ppoly_eval(_t(x), _t(c), _t(q), clamp).numpy()
    want = np.asarray(jsp.ppoly_eval_pallas(jnp.asarray(x), jnp.asarray(c),
                                            jnp.asarray(q), clamp=clamp,
                                            interpret=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, equal_nan=True)


def test_nan_query_stays_nan_under_clamp():
    """The hazard of a clamp that eats NaN: a NaN query must give NaN with
    clamp on, or an invalid parameter point turns into a finite chi^2."""
    x = _t(_knots(np.random.default_rng(2), 31))
    c = _t(_coeffs(x.numpy(), np.ones(31)))
    q = _t([np.nan, x[0] - 1, x[-1] + 1])
    out = tsp.ppoly_eval(x, c, q, clamp=True)
    assert torch.isnan(out[0]) and torch.isfinite(out[1:]).all()
    assert torch.isnan(torch.clamp(_t([np.nan]), x[0], x[-1]))[0]


def test_searchsorted_ties_match_numpy():
    rng = np.random.default_rng(3)
    x = _knots(rng, 31)
    q = np.concatenate([x, x, rng.uniform(0, 130, 100)])
    got = torch.searchsorted(_t(x), _t(q), right=True).numpy()
    np.testing.assert_array_equal(got, np.searchsorted(x, q, side='right'))


@pytest.mark.parametrize('name,args', [
    ('cubic_deriv_operator', lambda rng: (_knots(rng, 31),)),
    ('spline_eval_matrix', lambda rng: (_knots(rng, 31),
                                        rng.uniform(-5, 130, 40), 3)),
    ('gradient_matrix', lambda rng: (_knots(rng, 31),)),
    ('pchip_coeffs', lambda rng: (np.sort(rng.uniform(0.1, 0.6, 31)),
                                  rng.standard_normal((31, 2, 30)))),
])
def test_host_builders_equal_jax(name, args):
    a = args(np.random.default_rng(4))
    np.testing.assert_array_equal(getattr(tsp, name)(*a),
                                  getattr(jsp, name)(*a))


def test_hermite_coeffs_numpy_and_torch_agree():
    rng = np.random.default_rng(5)
    x = _knots(rng, 31)
    y, d = rng.standard_normal((2, 3, 31))
    np.testing.assert_array_equal(
        tsp.hermite_coeffs(_t(x), _t(y), _t(d)).numpy(),
        tsp.hermite_coeffs(x, y, d))


@pytest.mark.parametrize('clamp', [True, False])
def test_spline1d_matches_jax(clamp):
    rng = np.random.default_rng(6)
    x = _knots(rng, 31)
    y = rng.standard_normal((4, 31))
    q = _queries(rng, x, (4, 300))
    ts = tsp.Spline1D.build(x, clamp=clamp, device='cpu')
    js = jsp.Spline1D.build(x, clamp=clamp)
    got_c = ts.coeffs(_t(y)).numpy()
    want_c = np.asarray(jax.vmap(js.coeffs)(jnp.asarray(y)))
    # the derivative operator's matvec sums in another order in each package
    np.testing.assert_allclose(got_c, want_c, rtol=1e-13, atol=1e-15)
    got = ts(_t(y), _t(q)).numpy()
    want = np.asarray(jax.vmap(js)(jnp.asarray(y), jnp.asarray(q)))
    inf_q = np.isinf(q) if not clamp else np.zeros(q.shape, bool)
    np.testing.assert_allclose(got[~inf_q], want[~inf_q], rtol=0, atol=1e-12,
                               equal_nan=True)


def test_pchip_eval_and_table_match_jax():
    rng = np.random.default_rng(7)
    grid = np.sort(rng.uniform(0.1, 0.6, 31))
    table = rng.standard_normal((31, 2, 30))
    coeffs = tsp.pchip_coeffs(grid, table)
    beta = np.concatenate([grid[[0, 5, 30]], rng.uniform(0.05, 0.65, 20)])
    got = tsp.pchip_eval(_t(grid), _t(coeffs), _t(beta)).numpy()
    want = np.asarray(jax.vmap(lambda b: jsp.pchip_eval(
        jnp.asarray(grid), jnp.asarray(coeffs), b))(jnp.asarray(beta)))
    assert got.shape == (len(beta), 2, 30)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    scalar = tsp.PchipTable.build(grid, table, device='cpu')(
        _t(beta[3])).numpy()
    np.testing.assert_allclose(scalar, want[3], rtol=0, atol=ATOL)


def _surface(kind, rng):
    r = np.sort(rng.uniform(1.0, 120.0, 25))
    mu = np.linspace(0.0, 1.0, 21)
    if kind == 'rank1_y_const':       # an isotropic template tiled over mu
        return r, mu, np.outer(1.0 + np.exp(-r / 30.0), np.ones_like(mu))
    z = sum(np.outer(np.sin(r / (10.0 + 7 * k)), mu ** k) for k in range(3))
    return r, mu, z


@pytest.mark.parametrize('kind', ['rank1_y_const', 'rank3'])
def test_bicubic2d_matches_jax(kind):
    rng = np.random.default_rng(8)
    r, mu, z = _surface(kind, rng)
    tb = tsp.Bicubic2D.build(r, mu, z, device='cpu')
    jb = jsp.Bicubic2D.build(r, mu, z)
    assert tb.y_const == jb.y_const == (kind == 'rank1_y_const')
    for leaf in ('x', 'y', 'cu', 'cv'):
        np.testing.assert_array_equal(getattr(tb, leaf).numpy(),
                                      np.asarray(getattr(jb, leaf)))
    q = rng.uniform(-10.0, 140.0, (3, 500))      # clamped by .ev
    p = rng.uniform(-0.2, 1.2, (3, 500))
    got = tb.ev(_t(q), _t(p)).numpy()
    np.testing.assert_allclose(got, np.asarray(jb.ev(jnp.asarray(q),
                                                     jnp.asarray(p))),
                               rtol=0, atol=1e-12)
    from scipy.interpolate import RectBivariateSpline
    ref = RectBivariateSpline(r, mu, z).ev(q.ravel(), p.ravel())
    np.testing.assert_allclose(got.ravel(), ref, rtol=0, atol=1e-11)


def test_cheb_probe_inverse_equals_jax():
    for degree in (24, 48):
        for got, want in zip(tsp._cheb_probe_inverse(degree),
                             jsp._cheb_probe_inverse(degree)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('degree', [24, 48])
def test_chebyshev_fit_and_eval_match_jax(degree):
    """Per-row domains [x0 * resc, xn * resc] and per-row spline values, as
    the dispersion and streaming fast modes fit them; queries beyond both
    ends (clamped into the domain) and NaN."""
    rng = np.random.default_rng(30 + degree)
    x = _knots(rng, 31)
    y = rng.standard_normal((3, 31))
    resc = rng.uniform(0.95, 1.05, 3)
    a, b = x[0] * resc, x[-1] * resc
    ts, js = tsp.Spline1D.build(x, device='cpu'), jsp.Spline1D.build(x)
    c = ts.coeffs(_t(y))
    coef = tsp.chebyshev_fit(lambda r: ts.eval(c, r / _t(resc)[:, None]),
                             _t(a), _t(b), degree)
    assert coef.shape == (3, degree + 1)
    q = rng.uniform(a.min() - 5.0, b.max() + 5.0, (3, 7, 40))
    q[:, 0, :2] = np.nan
    got = tsp.chebyshev_eval(coef, _t(a), _t(b), _t(q)).numpy()
    for i in range(3):
        jc = js.coeffs(jnp.asarray(y[i]))
        jcoef = jsp.chebyshev_fit(lambda r: js.eval(jc, r / resc[i]), a[i],
                                  b[i], degree)
        np.testing.assert_allclose(coef[i].numpy(), np.asarray(jcoef), rtol=0,
                                   atol=ATOL)
        want = np.asarray(jsp.chebyshev_eval(jcoef, a[i], b[i],
                                             jnp.asarray(q[i])))
        np.testing.assert_allclose(got[i], want, rtol=0, atol=ATOL,
                                   equal_nan=True)
    assert np.isnan(got).sum() == 6


def test_chebyshev_interpolates_at_its_nodes():
    """The fit reproduces fn at the Chebyshev nodes of each row's domain."""
    a = _t([0.5, 2.0])
    b = _t([3.0, 9.0])
    fn = lambda r: torch.sin(r) * r          # noqa: E731
    coef = tsp.chebyshev_fit(fn, a, b, degree=16)
    _, nodes = tsp._cheb_probe_inverse(16)
    rn = 0.5 * (a + b)[:, None] + 0.5 * (b - a)[:, None] * _t(nodes)
    np.testing.assert_allclose(tsp.chebyshev_eval(coef, a, b, rn).numpy(),
                               fn(rn).numpy(), rtol=0, atol=1e-13)


@pytest.mark.parametrize('kind', ['Spline1D', 'PchipTable', 'Bicubic2D'])
def test_spline_build_defaults_to_the_card(kind):
    """The public `build` methods put their tables on the card unless the
    caller asks for the CPU: without a card, the default raises and names
    device='cpu' (no quiet fallback); with device='cpu' they build."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    x = np.linspace(0.0, 1.0, 7)
    args = {'Spline1D': (x,), 'PchipTable': (x, np.sin(x)),
            'Bicubic2D': (x, x, np.outer(np.sin(x), np.cos(x)))}[kind]
    cls = getattr(tsp, kind)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cls.build(*args)
    assert cls.build(*args, device='cpu').x.device.type == 'cpu'
