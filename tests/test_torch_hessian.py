"""The port's second derivatives against victor_tpu's: the spline lookup's
second-order terms (`kernels/ppoly.py::_PpolyEvalBackward`), the clip's and
the top-hat window's double backward, and the Hessian of the likelihood
for every model that the gradient paths reach, the joint fit and the
excursion-set model.

On the CPU the second-order terms run on the plain versions of the forward
and backward kernels; they are held against autograd through
`ppoly_eval_backward_plain` (what chip_smoke.py holds the card's terms to)
and against JAX's second derivatives of victor_tpu's ppoly_eval ('gather',
as on the CPU). The likelihood Hessians are taken by replicated rows
(`sampling.optimize.value_grad_hessian`), as the optimizers take them.
Everything is float64 with one thread.
"""

import ast
import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from victor_tpu.io import build_tables as jax_build_tables
from victor_tpu.models import eisenstein_hu as jeh
from victor_tpu.ops import splines as jsp
from victor_tpu.sampling import targets as jtargets
from victor_tpu_torch.io.tables import bundle_from_arrays, tables_to_arrays
from victor_tpu_torch.kernels import ppoly
from victor_tpu_torch.models import eisenstein_hu as teh
from victor_tpu_torch.ops import special as tspecial
from victor_tpu_torch.sampling import targets as ttargets
from victor_tpu_torch.sampling.optimize import value_grad_hessian
from victor_tpu_torch.utils.profiling import total

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ['fsigma8', 'beta', 'sigma_v', 'epsilon']
GOLDEN = [0.47, 0.37, 380.0, 1.0]
DISPLACED = [0.55, 0.45, 320.0, 1.05]
REDUCED = {'n_mu': 20, 'n_v': 10}       # a narrow width for the slower cases
#: the lookup kernel's forward, backward and second-order launch counters
ALL_PPOLY = ('ppoly.launches', 'ppoly.bwd_launches',
             'ppoly.second_order_launches')


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _lookup_inputs(seed, K, shared, clamp, B=3, M=30, n=7):
    """Knots, coefficients (Bc, K, n-1, 4), queries (B, M) with every knot,
    two points out of range, a NaN and (with clamp) both infinities planted
    at the front of each row, and grad_out g (B, K, M), cotangents u (B, M)
    of dq and V (coefficients' shape) of dcoeffs."""
    rng = np.random.default_rng(seed)
    x = np.concatenate([[0.01], np.sort(rng.uniform(2.0, 100.0, n - 1))])
    h = np.diff(x)[:, None] ** -np.arange(4.0)
    c = rng.standard_normal((1 if shared else B, K, n - 1, 4)) * h
    span = x[-1] - x[0]
    q = rng.uniform(x[0] - 0.05 * span, x[-1] + 0.05 * span, (B, M))
    special = list(x) + [x[0] - 1.0, x[-1] + 1.0, np.nan] + \
        ([np.inf, -np.inf] if clamp else [])
    q[:, :len(special)] = special
    return (x, c, q, rng.standard_normal((B, K, M)),
            rng.standard_normal((B, M)), rng.standard_normal(c.shape))


def _jax_loss(x, clamp):
    """sum(ppoly_eval(c, q) * g) over rows and channels, victor_tpu's
    'gather' strategy; c (Bc, K, n-1, 4), q (B, M), g (B, K, M)."""
    def loss(c, q, g):
        def row(cb, qb):
            return jax.vmap(lambda ck: jsp.ppoly_eval(
                jnp.asarray(x), ck, qb, clamp=clamp, strategy='gather'))(cb)
        if c.shape[0] == 1:
            out = jax.vmap(lambda qb: row(c[0], qb))(q)
        else:
            out = jax.vmap(row)(c, q)
        return jnp.sum(out * g)
    return loss


def _squeeze(a, K):
    """The port's layout of a channel-carrying array: 3D for K = 1."""
    return a if K > 1 else a[:, 0]


def _torch_second_order(x, c, q, g, u, V, K, clamp, through_plain=False):
    """d/d(c, q, g) of <V, dcoeffs> + <u, dq>, where (dq, dcoeffs) is the
    first derivative of sum(out * g): through PpolyEval's create_graph
    backward (the second-order Function), or with `through_plain` by
    autograd through ppoly_eval_backward_plain."""
    tc = _t(_squeeze(c, K)).requires_grad_()
    tq = _t(q).requires_grad_()
    tg = _t(_squeeze(g, K)).requires_grad_()
    if through_plain:
        dq, dc = ppoly.ppoly_eval_backward_plain(_t(x), tc, tq, tg, clamp)
    else:
        out = ppoly.PpolyEval.apply(_t(x), tc, tq, clamp)
        dc, dq = torch.autograd.grad((out * tg).sum(), (tc, tq),
                                     create_graph=True)
    s = (dc * _t(_squeeze(V, K))).sum() + (dq * _t(u)).sum()
    grads = torch.autograd.grad(s, (tc, tq, tg), allow_unused=True)
    return [torch.zeros_like(a) if d is None else d
            for d, a in zip(grads, (tc, tq, tg))]


def _close(got, want, tol=1e-12):
    """NaN positions identical, non-finite values equal, finite values
    within tol of max|want|."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin & ~np.isnan(want)],
                                  want[~fin & ~np.isnan(want)])
    scale = np.abs(want[fin]).max() if fin.any() else 1.0
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=tol * scale)


# ---------------------------------------------------------------------------
# the lookup's second-order terms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('K', [1, 2, 3])
@pytest.mark.parametrize('shared', [False, True])
@pytest.mark.parametrize('clamp', [True, False])
def test_second_order_matches_jax_and_plain(K, shared, clamp):
    """All three terms (to the coefficients, the queries and grad_out) of
    the second-order Function against JAX's reverse-over-reverse of
    victor_tpu's ppoly_eval and against autograd through the plain
    backward: per-row and shared tables, K = 1..3, clamp on and off, on
    queries at every knot (both bounds among them), out of range, NaN and
    infinite: within 1e-12 of the largest entry, NaN positions identical."""
    x, c, q, g, u, V = _lookup_inputs(10 * K + 2 * shared + clamp, K,
                                      shared, clamp)
    loss = _jax_loss(x, clamp)

    def first(c, q, g):
        return jax.grad(loss, argnums=(0, 1))(c, q, g)
    _, vjp = jax.vjp(first, jnp.asarray(c), jnp.asarray(q), jnp.asarray(g))
    want = [np.asarray(a) for a in vjp((jnp.asarray(V), jnp.asarray(u)))]
    want = [_squeeze(want[0], K), want[1], _squeeze(want[2], K)]
    got = _torch_second_order(x, c, q, g, u, V, K, clamp)
    plain = _torch_second_order(x, c, q, g, u, V, K, clamp,
                                through_plain=True)
    for a, p, w in zip(got, plain, want):
        _close(a, w)
        _close(p, w)


@pytest.mark.parametrize('K', [1, 2])
def test_second_order_at_infinite_queries_without_clamp(K):
    """Without clamp an infinite query makes the port's forward NaN (its
    `+ (qq - qq)` term; JAX's 'gather' strategy gives the end polynomial):
    there d/dq and d/dgrad_out are NaN, where JAX may have infinities;
    d/dcoeffs and every finite query agree with JAX's within 1e-12, NaN
    positions identical."""
    x, c, q, g, u, V = _lookup_inputs(90 + K, K, False, False)
    q[:, -2:] = [np.inf, -np.inf]
    loss = _jax_loss(x, False)

    def first(c, q, g):
        return jax.grad(loss, argnums=(0, 1))(c, q, g)
    _, vjp = jax.vjp(first, jnp.asarray(c), jnp.asarray(q), jnp.asarray(g))
    want = [np.asarray(a) for a in vjp((jnp.asarray(V), jnp.asarray(u)))]
    want = [_squeeze(want[0], K), want[1], _squeeze(want[2], K)]
    got = _torch_second_order(x, c, q, g, u, V, K, False)
    _close(got[0], want[0])
    inf = np.isinf(q)
    for a, w in zip(got[1:], want[1:]):
        a = a.detach().numpy()
        mask = inf if a.shape == q.shape else np.broadcast_to(
            inf[:, None], a.shape)
        assert np.isnan(a[mask]).all()
        _close(np.where(mask, 0.0, a), np.where(mask, 0.0, w))


@pytest.mark.parametrize('K,shared', [(1, False), (2, True), (3, False)])
def test_hessian_vector_product_matches_jax_jvp_of_grad(K, shared):
    """The Hessian of sum(out * g) to (c, q) applied to a tangent, against
    jax.jvp of jax.grad (forward over reverse, as jax.hessian takes it),
    with clamp, ties and NaN queries."""
    x, c, q, g, u, V = _lookup_inputs(70 + K, K, shared, True)
    loss = _jax_loss(x, True)
    rng = np.random.default_rng(K)
    tan_c, tan_q = rng.standard_normal(c.shape), rng.standard_normal(q.shape)

    def grad_cq(c, q):
        return jax.grad(loss, argnums=(0, 1))(c, q, jnp.asarray(g))
    _, (jc, jq) = jax.jvp(grad_cq, (jnp.asarray(c), jnp.asarray(q)),
                          (jnp.asarray(tan_c), jnp.asarray(tan_q)))
    tc = _t(_squeeze(c, K)).requires_grad_()
    tq = _t(q).requires_grad_()
    out = ppoly.PpolyEval.apply(_t(x), tc, tq, True)
    dc, dq = torch.autograd.grad((out * _t(_squeeze(g, K))).sum(), (tc, tq),
                                 create_graph=True)
    s = (dc * _t(_squeeze(tan_c, K))).sum() + (dq * _t(tan_q)).sum()
    hc, hq = torch.autograd.grad(s, (tc, tq))
    _close(hc, _squeeze(np.asarray(jc), K))
    _close(hq, np.asarray(jq))


@pytest.mark.parametrize('clamp', [True, False])
def test_second_derivative_at_ties_and_outside(clamp):
    """d^2 ppoly / dq^2 per query against jax.hessian: with clamp it is
    p''(q) inside, 0.25 p''(q) at either bound (the clip factor squared)
    and 0 outside; without clamp the end polynomials' p'' throughout."""
    rng = np.random.default_rng(5)
    x = np.concatenate([[0.01], np.sort(rng.uniform(2.0, 100.0, 6))])
    c = rng.standard_normal((6, 4)) * np.diff(x)[:, None] ** -np.arange(4.0)
    q = np.array([x[0], x[-1], x[0] - 1.0, x[-1] + 1.0, 0.5 * (x[2] + x[3]),
                  x[3]])
    want = np.diag(np.asarray(jax.hessian(lambda qq: jnp.sum(jsp.ppoly_eval(
        jnp.asarray(x), jnp.asarray(c), qq, clamp=clamp,
        strategy='gather')))(jnp.asarray(q))))
    tq = _t(q[None]).requires_grad_()
    out = ppoly.PpolyEval.apply(_t(x), _t(c[None]), tq, clamp)
    (dq,) = torch.autograd.grad(out.sum(), tq, create_graph=True)
    (d2,) = torch.autograd.grad(dq.sum(), tq)
    _close(d2[0], want)
    p2 = 2.0 * c[:, 2]          # p'' at the left end of each interval
    if clamp:
        assert d2[0, 0] == pytest.approx(0.25 * p2[0], rel=1e-12)
        assert float(d2[0, 2]) == 0.0 and float(d2[0, 3]) == 0.0


def test_second_order_gradgradcheck():
    """torch.autograd.gradgradcheck of PpolyEval against finite differences
    of its backward, away from knots and bounds, per-row and shared tables
    and two channels."""
    rng = np.random.default_rng(41)
    x = np.concatenate([[0.01], np.sort(rng.uniform(2.0, 60.0, 5))])
    mids = np.concatenate([[x[0] - 3.0], 0.5 * (x[:-1] + x[1:]),
                           [x[-1] + 3.0]])
    for lead, clamp in (((2,), True), ((1, 2), False)):
        c = rng.standard_normal(lead + (5, 4)) * \
            np.diff(x)[:, None] ** -np.arange(4.0)
        q = rng.choice(mids, (2, 4)) + rng.uniform(-0.3, 0.3, (2, 4))
        tc = _t(c).requires_grad_()
        tq = _t(q).requires_grad_()
        assert torch.autograd.gradgradcheck(
            lambda cc, qq: ppoly.PpolyEval.apply(_t(x), cc, qq, clamp),
            (tc, tq))


def test_second_order_counts_no_card_launches_on_cpu():
    """On CPU tensors the second-order terms run the plain versions: no
    launch is counted."""
    x, c, q, g, u, V = _lookup_inputs(3, 2, False, True)
    before = tuple(map(total, ALL_PPOLY))
    _torch_second_order(x, c, q, g, u, V, 2, True)
    assert tuple(map(total, ALL_PPOLY)) == before


def test_third_order_raises():
    """A backward of the second-order terms that records a graph (a third
    derivative) raises."""
    rng = np.random.default_rng(8)
    x = np.concatenate([[0.01], np.sort(rng.uniform(2.0, 60.0, 5))])
    tq = _t(rng.uniform(1.0, 50.0, (2, 5))).requires_grad_()
    c = _t(rng.standard_normal((2, 5, 4)))
    out = ppoly.PpolyEval.apply(_t(x), c, tq, True)
    (dq,) = torch.autograd.grad(out.sum(), tq, create_graph=True)
    with pytest.raises(RuntimeError, match='third'):
        torch.autograd.grad(dq.sum(), tq, create_graph=True)


# ---------------------------------------------------------------------------
# the other custom derivatives on the path
# ---------------------------------------------------------------------------

def test_clip_second_derivatives_match_jax():
    """jax.hessian of a smooth function of jnp.clip(a, lo, hi) to (a, lo,
    hi), with a inside, at both bounds and outside: the clip's own second
    derivative is 0 and its tie factor enters through the chain rule."""
    a = np.array([-1.0, 0.2, 0.5, 1.3, 2.0, 2.0, 0.2])
    lo, hi = 0.2, 2.0

    def f_jax(v):
        y = jnp.clip(v[:-2], v[-2], v[-1])
        return jnp.sum(jnp.sin(3.0 * y) * y)

    def f_torch(v):
        y = tspecial.clip(v[:-2], v[-2], v[-1])
        return torch.sum(torch.sin(3.0 * y) * y)
    v = np.concatenate([a, [lo, hi]])
    want = np.asarray(jax.hessian(f_jax)(jnp.asarray(v)))
    got = torch.autograd.functional.hessian(f_torch, _t(v))
    _close(got, want)


def test_tophat_window_second_derivative_matches_jax():
    """d^2 W / dx^2 of the top-hat window through its custom derivative
    rule (the backward calls the Function again), across the series and
    closed-form branches, against jax.hessian of victor_tpu's rule."""
    x = np.array([1e-5, 1e-3, 0.1, 0.3499, 0.35, 0.36, 1.0, 5.0, 20.0])
    want = np.asarray(jax.vmap(jax.hessian(jeh.tophat_window))(
        jnp.asarray(x)))
    tx = _t(x).requires_grad_()
    (d1,) = torch.autograd.grad(teh.tophat_window(tx).sum(), tx,
                                create_graph=True)
    (d2,) = torch.autograd.grad(d1.sum(), tx)
    np.testing.assert_allclose(d2.numpy(), want, rtol=1e-12, atol=1e-15)


# ---------------------------------------------------------------------------
# likelihood Hessians
# ---------------------------------------------------------------------------

def _chip_smoke_literals(*names):
    tree = ast.parse(open(os.path.join(REPO, 'chip_smoke.py')).read())
    found = {t.id: ast.literal_eval(node.value) for node in tree.body
             if isinstance(node, ast.Assign) for t in node.targets
             if isinstance(t, ast.Name) and t.id in names}
    return tuple(found[n] for n in names)


def _pair(model, data, **width):
    jb = jax_build_tables(copy.deepcopy(model), copy.deepcopy(data), **width)
    tb = bundle_from_arrays(tables_to_arrays(jb.tables),
                            dataclasses.asdict(jb.spec),
                            dataclasses.asdict(jb.theory_opts),
                            dataclasses.asdict(jb.fit_opts), device='cpu')
    return jb, tb


_JAX_HESSIANS = {}


def _jax_neg_hessian(jbundle, kw, names, points):
    """-jax.hessian of victor_tpu's lnL (AD-resolved modes) per point,
    computed once per bundle, case and points."""
    key = (id(jbundle), repr(kw), tuple(names), points.tobytes())
    if key not in _JAX_HESSIANS:
        tbl, loglike, _ = jtargets.resolve_target(jbundle, kw or None, None,
                                                  gradient_free=False)
        fn = jax.jit(jax.vmap(jax.hessian(
            lambda th: -loglike(tbl, dict(zip(names, th)))[0])))
        _JAX_HESSIANS[key] = np.asarray(fn(jnp.asarray(points)))
    return _JAX_HESSIANS[key]


def _torch_neg_hessian(tbundle, kw, names, points):
    """The port's -Hessian of lnL (AD-resolved modes) per point, by
    replicated rows."""
    tbl, loglike = ttargets.resolve_target(tbundle, kw or None, None,
                                           gradient_free=False)

    def neg(th):
        return -loglike(tbl, {k: th[:, i] for i, k in enumerate(names)})[0]
    _, _, H = value_grad_hessian(neg, _t(points))
    return H.numpy()


def _check_hessian(got, want, tol):
    assert np.isfinite(want).all() and np.isfinite(got).all()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * np.abs(w).max())


# chip_smoke.py's GRAD_CASES: opts_kw on configs/boss_config.yaml
CASES = {
    'streaming': {},
    "dispersion, final 'fast'": {'rsd_model': 'dispersion'},
    "dispersion, final 'exact'": {'rsd_model': 'dispersion',
                                  'dispersion_final': 'exact'},
    'kaiser': {'rsd_model': 'kaiser'},
    'assume_isotropic=False': {'assume_isotropic': False},
}


@pytest.fixture(scope='module')
def boss_pair(boss_config):
    return _pair(boss_config['model'], boss_config['data'])


@pytest.fixture(scope='module')
def reduced_pair(boss_config):
    return _pair(boss_config['model'], boss_config['data'], **REDUCED)


def test_boss_hessian_matches_jax_hessian_full_width(boss_pair):
    """The BOSS posterior's Hessian (streaming, AD-resolved modes) at full
    width, at the golden and a displaced point, against jax.hessian within
    1e-9 of max|H|; symmetric to the same tolerance."""
    jb, tb = boss_pair
    pts = np.array([GOLDEN, DISPLACED])
    got = _torch_neg_hessian(tb, {}, NAMES, pts)
    _check_hessian(got, _jax_neg_hessian(jb, {}, NAMES, pts), 1e-9)
    for h in got:
        np.testing.assert_allclose(h, h.T, rtol=0, atol=1e-9 * np.abs(h).max())


# the cases whose jax.hessian compiles in seconds here; the others (20-45 s
# of compile each) are held to central differences of the port's gradient,
# itself held to jax.grad by tests/test_torch_grad.py, and through
# HESS_GOLDENS to jax.hessian at full width (slow)
AGAINST_JAX = ('streaming', 'assume_isotropic=False')


def _fd_neg_hessian(tbundle, kw, names, points, rel=1e-5):
    """Central differences of the port's gradient of -lnL, one batch of
    rows: column i from steps of rel * |theta_i| along theta_i."""
    tbl, loglike = ttargets.resolve_target(tbundle, kw or None, None,
                                           gradient_free=False)
    d = points.shape[1]
    h = rel * np.abs(points)                                   # (P, d)
    steps = np.eye(d)[None] * h[:, None, :]                    # (P, d, d)
    rows = np.concatenate([points[:, None] + steps,
                           points[:, None] - steps], 1).reshape(-1, d)
    th = _t(rows).requires_grad_()
    lnl = loglike(tbl, {k: th[:, i] for i, k in enumerate(names)})[0]
    (g,) = torch.autograd.grad(-lnl.sum(), th)
    g = g.numpy().reshape(len(points), 2, d, d)
    H = (g[:, 0] - g[:, 1]) / (2.0 * h[:, :, None])            # row i: d/di
    return 0.5 * (H + np.swapaxes(H, 1, 2))


@pytest.mark.parametrize('name', list(CASES))
def test_hessian_of_every_gradient_case(reduced_pair, name):
    """Every case of chip_smoke's GRAD_CASES at a narrow width (n_mu 20,
    n_v 10): no op on the path lacks a double backward, and the Hessian
    matches jax.hessian within 1e-9 of max|H| (AGAINST_JAX), or central
    differences of the gradient within 1e-5 of max|H| off the kink at
    epsilon = 1."""
    jb, tb = reduced_pair
    kw = CASES[name]
    if name in AGAINST_JAX:
        pts = np.array([GOLDEN, DISPLACED])
        _check_hessian(_torch_neg_hessian(tb, kw, NAMES, pts),
                       _jax_neg_hessian(jb, kw, NAMES, pts), 1e-9)
    else:
        # at epsilon = 1 the AP map puts queries on the splines' bounds,
        # where lnL has a kink (the clip's tie rule gives its derivative):
        # central differences there straddle it, so epsilon = 1.01
        pts = np.array([GOLDEN[:3] + [1.01], DISPLACED])
        _check_hessian(_torch_neg_hessian(tb, kw, NAMES, pts),
                       _fd_neg_hessian(tb, kw, NAMES, pts), 1e-5)


def test_chip_smoke_hess_goldens_streaming(boss_pair):
    """chip_smoke.py holds the card's -Hessians of lnL (phase 13b) to
    victor_tpu's jax.hessian on the CPU in f64: this recomputes the
    streaming case's literals at both points (the other cases:
    test_chip_smoke_hess_goldens_other_cases, slow)."""
    cases, goldens = _chip_smoke_literals('GRAD_CASES', 'HESS_GOLDENS')
    assert list(cases) == list(CASES) == list(goldens)
    assert cases == CASES
    jb, _ = boss_pair
    want = _jax_neg_hessian(jb, {}, NAMES, np.array([GOLDEN, DISPLACED]))
    np.testing.assert_allclose(np.array(goldens['streaming']), want,
                               rtol=1e-10, atol=1e-12 * np.abs(want).max())


@pytest.mark.slow
def test_chip_smoke_hess_goldens_other_cases(boss_pair):
    """The rest of HESS_GOLDENS at full width (jax.hessian of the
    dispersion cases costs about 25 s each here)."""
    _, goldens = _chip_smoke_literals('GRAD_CASES', 'HESS_GOLDENS')
    jb, _ = boss_pair
    for name, kw in list(CASES.items())[1:]:
        want = _jax_neg_hessian(jb, kw, NAMES, np.array([GOLDEN, DISPLACED]))
        np.testing.assert_allclose(np.array(goldens[name]), want,
                                   rtol=1e-10,
                                   atol=1e-12 * np.abs(want).max(),
                                   err_msg=name)


def _esm_config():
    import yaml
    with open(os.path.join(REPO, 'configs', 'esm_sampling_config.yaml')) as f:
        cfg = yaml.safe_load(f)
    cfg['model']['dir'] = cfg['data']['dir'] = REPO
    return cfg


def test_esm_hessian_nine_parameters(boss_config):
    """The 9 x 9 Hessian of the excursion-set fit
    (configs/esm_sampling_config.yaml: f, sigma_8_0, b10, b01, Rp, Rx,
    beta, sigma_v, epsilon) at a narrow width, at the ref point and a
    displaced one: finite, and within 1e-8 of max|H| of jax.hessian."""
    cfg = _esm_config()
    names = list(cfg['params'])
    ref = np.array([cfg['params'][k]['ref']['loc'] for k in names])
    pts = np.array([ref, ref * (1.0 + 0.02 * (np.arange(9) % 3 - 1))])
    jb, tb = _pair(cfg['model'], cfg['data'], **REDUCED)
    _check_hessian(_torch_neg_hessian(tb, {}, names, pts),
                   _jax_neg_hessian(jb, {}, names, pts), 1e-8)


@pytest.fixture(scope='module')
def joint_pair(boss_config, tmp_path_factory):
    """Two copies of the BOSS data under the block-diagonal stack of its
    beta-dependent covariance (tests/test_multiquantile.py), each package
    building its own JointBundle from the one config."""
    import h5py
    from victor_tpu.likelihood.multiquantile import build_joint_tables as jbj
    from victor_tpu_torch.io.loaders import load_key_value_file
    from victor_tpu_torch.likelihood.multiquantile import build_joint_tables
    tmp = tmp_path_factory.mktemp('joint')
    data = boss_config['data']
    cdict = load_key_value_file(os.path.join(
        data['dir'], data['covariance_matrix']['data_file']))
    covs = np.asarray(cdict['covmat'])
    D = covs.shape[1]
    joint = np.zeros((len(covs), 2 * D, 2 * D))
    joint[:, :D, :D] = joint[:, D:, D:] = covs
    with h5py.File(tmp / 'joint_cov.hdf5', 'w') as f:
        f.create_dataset('covmat', data=joint)
        f.create_dataset('beta', data=np.asarray(cdict['beta']))
    q = {'model': copy.deepcopy(boss_config['model']),
         'data': {'redshift_space_ccf': copy.deepcopy(
             data['redshift_space_ccf']), 'dir': data['dir']}}
    cfg = {'quantiles': [copy.deepcopy(q), copy.deepcopy(q)],
           'covariance_matrix': {'data_file': str(tmp / 'joint_cov.hdf5'),
                                 'cov_key': 'covmat', 'fixed_beta': False,
                                 'beta_key': 'beta'},
           'likelihood': {'form': 'sellentin', 'nmocks': 1000}}
    return jbj(copy.deepcopy(cfg)), build_joint_tables(copy.deepcopy(cfg),
                                                       device='cpu')


def test_joint_hessian(joint_pair):
    """The two-quantile joint fit's Hessian at the golden and a displaced
    point against jax.hessian within 1e-9 of max|H|."""
    jjb, tjb = joint_pair
    pts = np.array([GOLDEN, DISPLACED])
    _check_hessian(_torch_neg_hessian(tjb, {}, NAMES, pts),
                   _jax_neg_hessian(jjb, {}, NAMES, pts), 1e-9)


def golden_esm_hessian():
    """ESM_HESS_GOLDENS: -jax.hessian of victor_tpu's lnL of
    configs/esm_sampling_config.yaml at its ref point (AD-resolved modes),
    9 x 9."""
    import yaml
    from victor_tpu.sampling import targets as jtargets
    with open(os.path.join(REPO, 'configs', 'esm_sampling_config.yaml')) as f:
        cfg = yaml.safe_load(f)
    cfg['model']['dir'] = cfg['data']['dir'] = REPO
    jb = jax_build_tables(cfg['model'], cfg['data'])
    names = list(cfg['params'])
    ref = jnp.asarray([cfg['params'][k]['ref']['loc'] for k in names])
    tbl, loglike, _ = jtargets.resolve_target(jb, None, None,
                                              gradient_free=False)
    H = jax.jit(jax.hessian(lambda th: -loglike(
        tbl, dict(zip(names, th)))[0]))(ref)
    return np.asarray(H).tolist()


def test_chip_smoke_esm_hessian_goldens():
    """chip_smoke.py holds the card's 9 x 9 ESM Hessian (phase 13g) to
    victor_tpu's jax.hessian at full width: this recomputes the literal,
    at the ref point that ESM_REF repeats."""
    (want, ref) = _chip_smoke_literals('ESM_HESS_GOLDENS', 'ESM_REF')
    cfg = _esm_config()
    assert ref == {k: cfg['params'][k]['ref']['loc'] for k in cfg['params']}
    got = np.array(golden_esm_hessian())
    np.testing.assert_allclose(np.array(want), got, rtol=0,
                               atol=1e-10 * np.abs(got).max())
