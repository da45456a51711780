"""The port's gradients against victor_tpu's `jax.grad`: the spline lookup's
autograd Function and its plain backward, JAX's tie rule of `jnp.clip` at
the four differentiated clamps, and d lnL / d theta of the batched
likelihood per row for every model and option that the gradient samplers
reach.

On the CPU the Function's backward is `ppoly_eval_backward_plain`, the
backward kernel's function in plain PyTorch; victor_tpu differentiates its
'gather' strategy on the CPU. Everything is float64 with one thread.
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
from victor_tpu.ops import splines as jsp
from victor_tpu.sampling import targets as jtargets
from victor_tpu_torch.io.tables import bundle_from_arrays, tables_to_arrays
from victor_tpu_torch.kernels import ppoly
from victor_tpu_torch.ops import special as tspecial
from victor_tpu_torch.ops import splines as tsp
from victor_tpu_torch.sampling import targets as ttargets

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ['fsigma8', 'beta', 'sigma_v', 'epsilon']


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _knots(rng, n):
    inner = np.linspace(2.5, 120.0, n - 1) + rng.uniform(-1.0, 1.0, n - 1)
    return np.concatenate([[0.01], inner])


def _coeffs(rng, x, lead):
    """Random piecewise-cubic coefficients (*lead, n-1, 4), the j-th scaled
    by h^-j so every piece stays of order one."""
    h = np.diff(x)[:, None] ** -np.arange(4.0)
    return rng.standard_normal(tuple(lead) + (len(x) - 1, 4)) * h


def _queries(rng, x, B, M, planted=True, inf=True):
    """(B, M) queries from 5% of the span beyond both ends; with `planted`,
    each row starts with every knot (both bounds among them), two points
    out of range, a NaN and (with `inf`) both infinities."""
    span = x[-1] - x[0]
    q = rng.uniform(x[0] - 0.05 * span, x[-1] + 0.05 * span, (B, M))
    if planted:
        special = list(x) + [x[0] - 1.0, x[-1] + 1.0, np.nan] + \
            ([np.inf, -np.inf] if inf else [])
        q[:, :len(special)] = special
    return q


def _jax_lookup_grads(x, c, q, w, clamp):
    """victor_tpu's ppoly_eval ('gather', as on the CPU) for per-row or
    shared tables of K channels, and jax.grad of sum(out * w) to (c, q).
    c (Bc, K, n-1, 4), q (B, M), w (B, K, M)."""
    def loss(c, q):
        def row(cb, qb):
            return jax.vmap(lambda ck: jsp.ppoly_eval(
                jnp.asarray(x), ck, qb, clamp=clamp, strategy='gather'))(cb)
        if c.shape[0] == 1:
            out = jax.vmap(lambda qb: row(c[0], qb))(q)
        else:
            out = jax.vmap(row)(c, q)
        return jnp.sum(out * jnp.asarray(w))
    dc, dq = jax.grad(loss, argnums=(0, 1))(jnp.asarray(c), jnp.asarray(q))
    return np.asarray(dc), np.asarray(dq)


def _abs_terms(x, c, q, w, clamp):
    """The scale of each coefficient gradient: the sum over its queries of
    |g| (1, |t|, t^2, |t|^3), in numpy; c (Bc, K, n-1, 4)."""
    n = len(x)
    qq = np.clip(q, x[0], x[-1]) if clamp else q
    # numpy's searchsorted, as torch's and JAX's, puts NaN last
    idx = np.clip(np.searchsorted(x, qq, side='right') - 1, 0, n - 2)
    t = np.abs(qq - x[idx])
    out = np.zeros(c.shape)
    for b in range(q.shape[0]):
        r = b if c.shape[0] > 1 else 0
        for k in range(c.shape[1]):
            g = np.abs(w[b, k])
            for j in range(4):
                np.add.at(out[r, k, :, j], idx[b], np.nan_to_num(
                    g * t[b] ** j, nan=0.0, posinf=0.0))
    return out


def _check(got, want, scale, tol=1e-12):
    got = got.detach().numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    err = np.abs(got - want)[fin]
    bound = tol * (scale[fin] if np.ndim(scale) else scale)
    assert np.all(err <= bound), float((err - bound).max())


# ---------------------------------------------------------------------------
# the lookup's autograd Function and its plain backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('K', [1, 2, 3, 4])
@pytest.mark.parametrize('shared', [False, True])
@pytest.mark.parametrize('clamp', [True, False])
def test_function_backward_matches_jax_grad(K, shared, clamp):
    """PpolyEval on CPU tensors against jax.grad of victor_tpu's ppoly_eval
    per row and channel, on queries at every knot, at both bounds (where
    jnp.clip's derivative is 0.5), out of range and NaN: dq within 1e-12 of
    its largest value, dcoeffs within 1e-12 of the sum of its terms'
    magnitudes, NaN positions identical. Infinite queries only with clamp
    (unclamped, the forward's `+ (qq - qq)` term makes them NaN)."""
    rng = np.random.default_rng(10 * K + 2 * shared + clamp)
    B, M, n = 3, 60, 9
    x = _knots(rng, n)
    c = _coeffs(rng, x, (1 if shared else B, K))
    q = _queries(rng, x, B, M, inf=clamp)
    w = rng.standard_normal((B, K, M))
    jdc, jdq = _jax_lookup_grads(x, c, q, w, clamp)

    tc = _t(c if K > 1 else c[:, 0]).requires_grad_()
    tq = _t(q).requires_grad_()
    out = ppoly.PpolyEval.apply(_t(x), tc, tq, clamp)
    assert out.shape == ((B, K, M) if K > 1 else (B, M))
    tw = _t(w if K > 1 else w[:, 0])
    (out * torch.nan_to_num(tw)).sum().backward()
    fin = np.isfinite(jdq)
    _check(tq.grad, jdq, float(np.abs(jdq[fin]).max()))
    dc = tc.grad if K > 1 else tc.grad[:, None]
    _check(dc, jdc, _abs_terms(x, c, q, w, clamp))
    # the bounds take half the derivative; out of range none
    if clamp:
        knots = tq.grad[:, :n].detach().numpy()
        inner = np.asarray(jdq)[:, :n]
        np.testing.assert_array_equal(knots[:, [0, -1]] != 0,
                                      inner[:, [0, -1]] != 0)
        assert np.all(tq.grad[:, n:n + 2].numpy() == 0.0)


@pytest.mark.parametrize('K,shared,clamp', [(1, False, True), (1, True, False),
                                            (2, False, True), (3, True, True)])
def test_function_gradcheck(K, shared, clamp):
    """torch.autograd.gradcheck of PpolyEval (plain forward and backward)
    against finite differences, away from knots and bounds."""
    rng = np.random.default_rng(40 + K)
    B, M, n = 2, 5, 6
    x = _knots(rng, n)
    c = _coeffs(rng, x, (1 if shared else B, K))
    mids = np.concatenate([[x[0] - 3.0], 0.5 * (x[:-1] + x[1:]),
                           [x[-1] + 3.0]])
    q = rng.choice(mids, (B, M)) + rng.uniform(-0.3, 0.3, (B, M))
    tc = _t(c if K > 1 else c[:, 0]).requires_grad_()
    tq = _t(q).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda cc, qq: ppoly.PpolyEval.apply(_t(x), cc, qq, clamp), (tc, tq))


def test_plain_backward_partial_and_shapes():
    """ppoly_eval_backward_plain: dq-only and dcoeffs-only calls give the
    values of a full one; a row of finite queries whose grad_out is zero
    adds nothing."""
    rng = np.random.default_rng(5)
    x = _t(_knots(rng, 12))
    c = _t(_coeffs(rng, x.numpy(), (4, 2)))
    q = _t(_queries(rng, x.numpy(), 4, 40))
    q[1] = _t(_queries(rng, x.numpy(), 1, 40, planted=False))
    g = _t(rng.standard_normal((4, 2, 40)))
    g[1] = 0.0
    dq, dc = ppoly.ppoly_eval_backward_plain(x, c, q, g)
    dq1, none1 = ppoly.ppoly_eval_backward_plain(x, c, q, g,
                                                  want_dcoeffs=False)
    none2, dc2 = ppoly.ppoly_eval_backward_plain(x, c, q, g, want_dq=False)
    assert none1 is None and none2 is None
    assert torch.equal(torch.nan_to_num(dq), torch.nan_to_num(dq1))
    assert torch.equal(torch.nan_to_num(dc), torch.nan_to_num(dc2))
    assert dq.shape == q.shape and dc.shape == c.shape
    assert torch.all(dc[1] == 0.0) and torch.all(dq[1] == 0.0)


def test_function_refuses_knot_gradients_and_second_order():
    """x takes no gradient; second derivatives exist (the backward records
    a graph through its own Function), and a third derivative raises."""
    rng = np.random.default_rng(6)
    x = _knots(rng, 8)
    c = _t(_coeffs(rng, x, (2,))).requires_grad_()
    q = _t(rng.uniform(1.0, 100.0, (2, 9))).requires_grad_()
    with pytest.raises(RuntimeError, match='knots'):
        ppoly.PpolyEval.apply(_t(x).requires_grad_(), c, q, True)
    out = ppoly.PpolyEval.apply(_t(x), c, q, True)
    (dq,) = torch.autograd.grad(out.sum(), q, create_graph=True)
    (d2,) = torch.autograd.grad(dq.sum(), q, retain_graph=True)
    assert torch.isfinite(d2).all()
    with pytest.raises(RuntimeError, match='third'):
        torch.autograd.grad(dq.sum(), q, create_graph=True)


def test_ops_dispatch_records_a_graph_only_under_gradients(monkeypatch):
    """ops.splines.ppoly_eval and ppoly_eval_multi go through PpolyEval
    only while a gradient to q or the coefficients is recorded; otherwise
    they call the lookup directly, and both give the same values."""
    rng = np.random.default_rng(7)
    x = _t(_knots(rng, 10))
    c = _t(_coeffs(rng, x.numpy(), (3,)))
    cm = _t(_coeffs(rng, x.numpy(), (3, 2)))
    q = _t(rng.uniform(0.0, 130.0, (3, 4, 5)))
    applied = []
    real = ppoly.PpolyEval.apply
    monkeypatch.setattr(tsp.PpolyEval, 'apply',
                        lambda *a: applied.append(1) or real(*a))
    plain = tsp.ppoly_eval(x, c, q), tsp.ppoly_eval_multi(x, cm, q)
    with torch.no_grad():
        tsp.ppoly_eval(x, c, q.clone().requires_grad_())
    assert not applied
    qg = q.clone().requires_grad_()
    graded = tsp.ppoly_eval(x, c, qg), tsp.ppoly_eval_multi(x, cm, qg)
    assert len(applied) == 2
    for a, b in zip(plain, graded):
        assert torch.equal(a, b.detach())
        assert b.requires_grad
    assert graded[1].shape == (3, 2, 4, 5)


# ---------------------------------------------------------------------------
# jnp.clip's tie rule at the four differentiated clamps
# ---------------------------------------------------------------------------

def test_clip_matches_jnp_clip_and_its_derivative():
    """ops.special.clip: torch.clamp's values (NaN stays NaN) and
    jnp.clip's derivative to a, lo and hi at lo, inside, hi, out of range
    and with lo == hi."""
    a = np.array([0.0, 0.5, 1.0, 2.0, -1.0, np.nan])
    lo, hi = np.zeros(6), np.ones(6)
    ta, tlo, thi = (_t(v).requires_grad_() for v in (a, lo, hi))
    out = tspecial.clip(ta, tlo, thi)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  torch.clamp(_t(a), 0.0, 1.0).numpy())
    out.backward(torch.ones(6, dtype=torch.float64))
    want = jax.vmap(jax.grad(jnp.clip, argnums=(0, 1, 2)))(
        jnp.asarray(a), jnp.asarray(lo), jnp.asarray(hi))
    for g, w in zip((ta.grad, tlo.grad, thi.grad), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(ta.grad.numpy()[:5], [0.5, 1.0, 0.5, 0, 0])
    z = torch.zeros(1, dtype=torch.float64, requires_grad=True)
    zl, zh = (torch.zeros(1, dtype=torch.float64, requires_grad=True)
              for _ in range(2))
    tspecial.clip(z, zl, zh).sum().backward()
    want = jax.grad(jnp.clip, argnums=(0, 1, 2))(0.0, 0.0, 0.0)
    assert [float(v.grad) for v in (z, zl, zh)] == [float(w) for w in want]
    # without a gradient: selects, the same values, no graph
    plain = tspecial.clip(_t(a), 0.0, 1.0)
    assert not plain.requires_grad
    np.testing.assert_array_equal(plain.numpy(), out.detach().numpy())


def _tie_points(lo, hi):
    """lo, inside, hi and beyond both ends."""
    return np.array([lo, 0.37 * lo + 0.63 * hi, hi, lo - 0.3 * (hi - lo),
                     hi + 0.2 * (hi - lo)])


@pytest.mark.parametrize('clamp', [True, False])
def test_ppoly_eval_tie_rule(clamp):
    rng = np.random.default_rng(8)
    x = _knots(rng, 14)
    c = _coeffs(rng, x, ())
    q = _tie_points(x[0], x[-1])[None]
    jg = jax.grad(lambda qq: jnp.sum(jsp.ppoly_eval(
        jnp.asarray(x), jnp.asarray(c), qq, clamp=clamp,
        strategy='gather')))(jnp.asarray(q))
    tq = _t(q).requires_grad_()
    tsp.ppoly_eval(_t(x), _t(c), tq, clamp=clamp).sum().backward()
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(jg), rtol=1e-13,
                               atol=0)
    if clamp:
        assert tq.grad[0, 3] == 0 and tq.grad[0, 4] == 0


@pytest.mark.parametrize('y_const', [False, True])
def test_bicubic_ev_tie_rule(y_const):
    rng = np.random.default_rng(9)
    r = np.sort(rng.uniform(1.0, 120.0, 20))
    mu = np.linspace(0.0, 1.0, 11)
    z = np.outer(np.sin(r / 17.0), np.ones_like(mu)) if y_const else \
        sum(np.outer(np.sin(r / (10.0 + 7 * k)), mu ** k) for k in range(3))
    js, ts = jsp.Bicubic2D.build(r, mu, z), tsp.Bicubic2D.build(r, mu, z)
    assert ts.y_const == y_const
    q, p = np.meshgrid(_tie_points(r[0], r[-1]), _tie_points(0.0, 1.0))
    jq, jpp = jax.grad(lambda a, b: jnp.sum(js.ev(a, b)), argnums=(0, 1))(
        jnp.asarray(q), jnp.asarray(p))
    tq, tp_ = _t(q).requires_grad_(), _t(p).requires_grad_()
    ts.ev(tq, tp_).sum().backward()
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(jq), rtol=1e-12,
                               atol=1e-15)
    if y_const:
        assert tp_.grad is None or not bool(tp_.grad.any())
        assert not np.asarray(jpp).any()
    else:
        np.testing.assert_allclose(tp_.grad.numpy(), np.asarray(jpp),
                                   rtol=1e-12, atol=1e-15)


def test_chebyshev_eval_tie_rule():
    """chebyshev_eval's clip of u into [-1, 1]: gradients to q and to the
    domain ends a and b, per row against victor_tpu's scalar call."""
    rng = np.random.default_rng(10)
    coef = rng.standard_normal((2, 9)) / (1.0 + np.arange(9.0)) ** 2
    a, b = np.array([1.0, 3.0]), np.array([50.0, 80.0])
    q = np.stack([_tie_points(a[i], b[i]) for i in range(2)])
    tq, ta, tb = (_t(v).requires_grad_() for v in (q, a, b))
    tsp.chebyshev_eval(_t(coef), ta, tb, tq).sum().backward()
    for i in range(2):
        jg = jax.grad(lambda qq, aa, bb: jnp.sum(jsp.chebyshev_eval(
            jnp.asarray(coef[i]), aa, bb, qq)), argnums=(0, 1, 2))(
            jnp.asarray(q[i]), a[i], b[i])
        for got, want in zip((tq.grad[i], ta.grad[i], tb.grad[i]), jg):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize('clamp', [True, False])
def test_ppoly_eval_dynamic_tie_rule(clamp):
    """The excursion-set model's lookup on traced knots: gradients to the
    knots (through t and through the clip's ends), the coefficients and q,
    per row against victor_tpu's masksum."""
    rng = np.random.default_rng(11)
    x = np.stack([_knots(rng, 10), _knots(rng, 10)])
    c = np.stack([_coeffs(rng, x[i], ()) for i in range(2)])
    q = np.stack([np.concatenate([_tie_points(x[i, 0], x[i, -1]), x[i, 3:5]])
                  for i in range(2)])
    tx, tc, tq = (_t(v).requires_grad_() for v in (x, c, q))
    tsp.ppoly_eval_dynamic(tx, tc, tq, clamp=clamp).sum().backward()
    for i in range(2):
        jg = jax.grad(lambda xx, cc, qq: jnp.sum(jsp.ppoly_eval_dynamic(
            xx, cc, qq, clamp=clamp)), argnums=(0, 1, 2))(
            jnp.asarray(x[i]), jnp.asarray(c[i]), jnp.asarray(q[i]))
        for got, want in zip((tx.grad[i], tc.grad[i], tq.grad[i]), jg):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# d lnL / d theta of the likelihood, per row
# ---------------------------------------------------------------------------

GOLDEN = [0.47, 0.37, 380.0, 1.0]
DISPLACED = [0.55, 0.45, 320.0, 1.05]


def _chip_smoke_literals(*names):
    """Top-level literals of chip_smoke.py, read with ast (importing the
    script would install its import hook that refuses jax)."""
    tree = ast.parse(open(os.path.join(REPO, 'chip_smoke.py')).read())
    found = {t.id: ast.literal_eval(node.value) for node in tree.body
             if isinstance(node, ast.Assign) for t in node.targets
             if isinstance(t, ast.Name) and t.id in names}
    return tuple(found[n] for n in names)


def _pair(model, data):
    jb = jax_build_tables(copy.deepcopy(model), copy.deepcopy(data))
    tb = bundle_from_arrays(tables_to_arrays(jb.tables),
                            dataclasses.asdict(jb.spec),
                            dataclasses.asdict(jb.theory_opts),
                            dataclasses.asdict(jb.fit_opts), device='cpu')
    return jb, tb


def _esm_config():
    import yaml
    with open(os.path.join(REPO, 'configs', 'esm_sampling_config.yaml')) as f:
        cfg = yaml.safe_load(f)
    cfg['model']['dir'] = cfg['data']['dir'] = REPO
    return cfg


# name -> (model-block replacements of configs/boss_config.yaml, opts_kw);
# chip_smoke.py's GRAD_CASES are the first five
LIKELIHOOD_CASES = {
    'streaming': ({}, {}),
    "dispersion, final 'fast'": ({}, {'rsd_model': 'dispersion'}),
    "dispersion, final 'exact'": ({}, {'rsd_model': 'dispersion',
                                       'dispersion_final': 'exact'}),
    'kaiser': ({}, {'rsd_model': 'kaiser'}),
    'assume_isotropic=False': ({}, {'assume_isotropic': False}),
    'euclid_special': ({}, {'rsd_model': 'euclid_special'}),
    'linear_bias': ({'matter_ccf': {'model': 'linear_bias', 'bias': 1.9,
                                    'template_sigma8': 0.628}}, {}),
}


class _Cases:
    """Each case's pair of bundles, built once, and victor_tpu's gradients
    at its points, computed once (jit of vmap of jax.grad)."""

    def __init__(self, boss_config):
        self.cfg = boss_config
        self.pairs, self.grads = {}, {}

    def case(self, name):
        if name not in self.pairs:
            if name == 'esm':
                cfg = _esm_config()
                names = list(cfg['params'])
                ref = {k: v['ref']['loc'] if isinstance(v['ref'], dict)
                       else v['ref'] for k, v in cfg['params'].items()}
                pts = [[ref[k] for k in names],
                       [ref[k] * (1.0 + 0.02 * (i % 3 - 1))
                        for i, k in enumerate(names)]]
                self.pairs[name] = (_pair(cfg['model'], cfg['data']), {},
                                    names, np.array(pts), {})
            else:
                edits, kw = LIKELIHOOD_CASES[name]
                extra = {'bias': 1.9} if 'matter_ccf' in edits else {}
                self.pairs[name] = (_pair({**copy.deepcopy(self.cfg['model']),
                                           **edits}, self.cfg['data']),
                                    kw, NAMES, np.array([GOLDEN, DISPLACED]),
                                    extra)
        return self.pairs[name]

    def jax_grad(self, name):
        if name not in self.grads:
            (jb, _), kw, names, pts, extra = self.case(name)
            tbl, loglike, _ = jtargets.resolve_target(jb, kw or None, None,
                                                      gradient_free=False)

            def lnl(th):
                return loglike(tbl, {**dict(zip(names, th)), **extra})[0]
            fn = jax.jit(jax.vmap(jax.value_and_grad(lnl)))
            val, grad = fn(jnp.asarray(pts))
            self.grads[name] = (np.asarray(val), np.asarray(grad))
        return self.grads[name]


@pytest.fixture(scope='module')
def cases(boss_config):
    return _Cases(boss_config)


@pytest.mark.parametrize('name', list(LIKELIHOOD_CASES) + ['esm'])
def test_loglike_gradient_per_row_matches_jax(cases, name):
    """One batch of two points through the port's sampler target (the
    AD-resolved perf modes: streaming_eval and beta_covariance 'exact',
    dispersion_final 'fast' unless asked for 'exact'), differentiated by one
    autograd.grad of the summed lnL, against victor_tpu's jax.grad at each
    point: lnL within 1e-9, each gradient entry within 1e-9 relative."""
    (_, tb), kw, names, pts, extra = cases.case(name)
    want_lnl, want = cases.jax_grad(name)
    tbl, loglike = ttargets.resolve_target(tb, kw or None, None,
                                           gradient_free=False)
    th = _t(pts).requires_grad_()
    params = {**{k: th[:, i] for i, k in enumerate(names)},
              **{k: torch.full((len(pts),), v, dtype=torch.float64)
                 for k, v in extra.items()}}
    lnl, _ = loglike(tbl, params)
    (grad,) = torch.autograd.grad(lnl.sum(), th)
    np.testing.assert_allclose(lnl.detach().numpy(), want_lnl, rtol=0,
                               atol=1e-9)
    assert np.isfinite(want).all() and np.abs(want).max() > 0
    np.testing.assert_allclose(grad.numpy(), want, rtol=1e-9,
                               atol=1e-12 * np.abs(want).max())


def test_chip_smoke_grad_goldens_match_victor_tpu(cases):
    """chip_smoke.py holds the card's d lnL / d theta to victor_tpu's
    jax.grad on the CPU (f64, AD-resolved modes) at GOLDEN and DISPLACED:
    this recomputes each literal of GRAD_GOLDENS."""
    grad_cases, goldens = _chip_smoke_literals('GRAD_CASES', 'GRAD_GOLDENS')
    assert list(grad_cases) == list(LIKELIHOOD_CASES)[:5] == list(goldens)
    for name, kw in grad_cases.items():
        assert kw == LIKELIHOOD_CASES[name][1]
        _, want = cases.jax_grad(name)
        np.testing.assert_allclose(np.array(goldens[name]), want, rtol=1e-10,
                                   atol=0, err_msg=name)
