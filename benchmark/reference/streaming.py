"""The Gaussian streaming model of the void-galaxy cross-correlation and its
Sellentin likelihood, written from the model's equations in plain NumPy,
SciPy and PyTorch (Nadathur et al. 2019, arXiv:1904.01030, sections 3-4;
Sellentin & Heavens 2016 for the likelihood).

For a parameter point (f sigma_8, beta, sigma_v, epsilon):

* Alcock-Paczynski: a_par = epsilon^(-2/3), a_perp = epsilon a_par. The
  templates' radial scale is stretched by the mean of a_par (1 + (1 - mu^2)
  (epsilon^2 - 1))^(1/2) over mu in [1e-10, 1] (50-node trapezoid).
* Real space: the void-galaxy monopole xi_r(r; beta), interpolated over the
  reconstruction's beta grid by PCHIP and in r by a not-a-knot cubic
  spline, held at its end values beyond the grid.
* Mean velocity (linear theory): v_r(r) = -(f sigma_8 / sigma_8,template)
  r Delta(r) / (3 iaH a_par), Delta(r) = 3 / r^3 int_0^r delta(x) x^2 dx of
  the matter template delta, on r_v = [0.01, r]; iaH = (1 + z) / H(z) in
  units of H_0 = 100 (flat LCDM).
* Dispersion: sigma_v times the template sigma_v(r) smoothed by a 3-point
  linear Savitzky-Golay filter and divided by its value at the largest r.
* Streaming: xi_s(s, mu) = int (1 + xi_r(r)) N(v; v_r(r) mu_r, sigma(r)) dv
  - 1 over v = sigma_v x, x on 50 nodes in [-6, 6] (Simpson's rule, the
  average of its two end corrections for an even count), with
  r_par = s mu a_par - v iaH a_par, r_perp = s (1 - mu^2)^(1/2) a_perp.
* Multipoles: xi_s on 100 mu nodes in [0, 1], a not-a-knot spline in mu
  resampled on 200 nodes, (2 l + 1) int P_l xi_s dmu by the trapezoid rule.
* Likelihood: the data vector PCHIP-interpolated in beta; the covariance
  and its inverse blended between the grid matrix below beta and the last
  grid matrix, as the published fitting code does (the exact grid matrix at
  a node, the end matrices beyond the grid); lnL = -(n_mocks / 2)
  ln(1 + chi^2 / (n_mocks - 1)) - ln det(C) / 2.

`streaming_eval: fast` replaces v_r and the dispersion template along each
line of sight by their degree-48 Chebyshev interpolants over the rescaled
template range (the nodes cos((2k + 1) pi / 98)); `beta_covariance` exact
and factored are one quantity, computed here from the dense blend.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
CHEB_DEGREE = 48
PARAMS = ('fsigma8', 'beta', 'sigma_v', 'epsilon')
STREAMING_EVAL = ('exact', 'fast')
BETA_COVARIANCE = ('exact', 'factored')


# ---------------------------------------------------------------------------
# host: the model's fixed ingredients from the raw files (float64 numpy)
# ---------------------------------------------------------------------------

def not_a_knot_operator(x: np.ndarray) -> np.ndarray:
    """K (n, n) with K @ y the second derivatives at the knots x of the
    not-a-knot cubic spline through (x, y): continuity of the second
    derivative at every interior knot, and of the third at x[1] and x[-2]."""
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    h = np.diff(x)
    A = np.zeros((n, n))
    R = np.zeros((n, n))
    A[0, :3] = [h[1], -(h[0] + h[1]), h[0]]
    A[-1, -3:] = [h[-1], -(h[-2] + h[-1]), h[-2]]
    for i in range(1, n - 1):
        A[i, i - 1:i + 2] = [h[i - 1], 2.0 * (h[i - 1] + h[i]), h[i]]
        R[i, i - 1:i + 2] = [6.0 / h[i - 1], -6.0 / h[i - 1] - 6.0 / h[i],
                             6.0 / h[i]]
    return np.linalg.solve(A, R)


def spline_host(x, y, q):
    """The not-a-knot spline through (x, y) at q, q clamped into the knots'
    range (numpy)."""
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    m = not_a_knot_operator(x) @ y
    qc = np.clip(q, x[0], x[-1])
    i = np.clip(np.searchsorted(x, qc, side='right') - 1, 0, len(x) - 2)
    h = x[i + 1] - x[i]
    a, b = x[i + 1] - qc, qc - x[i]
    return (m[i] * a ** 3 + m[i + 1] * b ** 3) / (6.0 * h) \
        + (y[i] - m[i] * h * h / 6.0) * a / h \
        + (y[i + 1] - m[i + 1] * h * h / 6.0) * b / h


def enclosed_density(r_delta, delta, r_out) -> np.ndarray:
    """Delta(r) = 3 / r^3 int_0^r delta(x) x^2 dx for the not-a-knot spline
    delta through (r_delta, delta), held at its end values outside the grid;
    exact on each spline piece (5-point Gauss-Legendre, degree 9 >= 5)."""
    gx, gw = np.polynomial.legendre.leggauss(5)
    r_delta = np.asarray(r_delta, np.float64)
    out = []
    for r in np.atleast_1d(r_out):
        lo = min(r, r_delta[0])
        total = delta[0] * lo ** 3 / 3.0
        edges = np.concatenate([r_delta[r_delta < r], [min(r, r_delta[-1])]])
        for a, b in zip(edges[:-1], edges[1:]):
            mid, half = 0.5 * (a + b), 0.5 * (b - a)
            xs = mid + half * gx
            total += half * np.sum(gw * spline_host(r_delta, delta, xs) * xs ** 2)
        if r > r_delta[-1]:
            total += delta[-1] * (r ** 3 - r_delta[-1] ** 3) / 3.0
        out.append(3.0 * total / r ** 3)
    return np.array(out)


def simpson_avg_weights(n: int, dx: float) -> np.ndarray:
    """Weights of Simpson's rule on n equally spaced nodes; for an even n the
    mean of (Simpson on the first n - 1 nodes + a trapezoid on the last
    interval) and (a trapezoid on the first + Simpson on the last n - 1)."""
    def simpson(m):
        w = np.ones(m)
        w[1:-1:2], w[2:-1:2] = 4.0, 2.0
        return w * dx / 3.0
    if n % 2:
        return simpson(n)
    first = np.concatenate([simpson(n - 1), [0.0]])
    first[-2:] += 0.5 * dx
    last = np.concatenate([[0.0], simpson(n - 1)])
    last[:2] += 0.5 * dx
    return 0.5 * (first + last)


def trapezoid_weights(x) -> np.ndarray:
    x = np.asarray(x, np.float64)
    w = np.zeros_like(x)
    w[:-1] += 0.5 * np.diff(x)
    w[1:] += 0.5 * np.diff(x)
    return w


def pchip_pieces(x, table) -> np.ndarray:
    """scipy's PCHIP of table (n, ...) over x: its pieces (n - 1, 4, ...),
    highest power first, in the local variable beta - x[i]."""
    from scipy.interpolate import PchipInterpolator
    c = PchipInterpolator(np.asarray(x, np.float64),
                          np.asarray(table, np.float64), axis=0).c
    return np.ascontiguousarray(np.moveaxis(c, 0, 1))


def _load(path: str) -> Dict[str, np.ndarray]:
    p = Path(path)
    with np.load(p if p.is_absolute() else ROOT / p) as z:
        return {k: np.asarray(z[k], np.float64) for k in z.files}


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f'the reference does not know {what}')


def host_arrays(config: Dict) -> Dict:
    """Every fixed ingredient of the model as float64 numpy, from the raw
    files and the configuration's settings. Raises ValueError for a setting
    the reference does not implement."""
    model, data = config['model'], config['data']
    real, matter = model['realspace_ccf'], model['matter_ccf']
    vel = model['velocity_pdf']
    disp = vel['dispersion']
    like = data['likelihood']
    rs, cov_cfg = data['redshift_space_ccf'], data['covariance_matrix']
    _require(model.get('rsd_model') == 'streaming', 'this rsd_model')
    _require(real.get('reconstruction') and real.get('assume_isotropic', True)
             and real.get('format', 'multipoles') == 'multipoles'
             and not real.get('from_data', False),
             'this realspace_ccf')
    _require(matter.get('model') == 'template'
             and not matter.get('integrated', False), 'this matter_ccf')
    _require(vel['mean'].get('model', 'linear') == 'linear'
             and not vel['mean'].get('empirical_corr', False)
             and vel.get('form', 'gaussian') == 'gaussian', 'this mean model')
    _require(disp.get('model') == 'template'
             and len(disp['template_keys']) == 2
             and disp.get('filter', True), 'this dispersion model')
    _require(vel.get('rescale_templates_independent_of_AP') is False,
             'AP-independent templates')
    _require(rs.get('reconstruction') and rs.get('format', 'multipoles')
             == 'multipoles' and not cov_cfg.get('fixed_beta', True)
             and data.get('beta_interpolation') == 'datavector'
             and like.get('form', '').lower() == 'sellentin',
             'this data block')
    _require(list(config['params']) == list(PARAMS),
             f'parameters other than {PARAMS}')

    m = _load(model['input_model_data_file'])
    d = _load(rs['data_file'])
    c = _load(cov_cfg['data_file'])
    n_mu, n_v = int(config['n_mu']), int(config['n_v'])

    om = float(model.get('cosmology', {}).get('Omega_m', 0.31))
    z = float(model['z_eff'])
    iaH = (1.0 + z) / (100.0 * math.sqrt(om * (1.0 + z) ** 3 + 1.0 - om))

    r = m[real['ccf_keys'][0]]
    xi0 = m[real['ccf_keys'][1]]                          # (n_beta, n_r)
    r_v = np.concatenate([[0.01], r])
    r_key, delta_key = matter['template_keys']
    r_delta, delta = m[r_key], m[delta_key]
    r50 = np.linspace(r_delta.min(), r_delta.max(), 50)
    Delta_rv = spline_host(r50, enclosed_density(r_delta, delta, r50), r_v)

    rsv_key, sv_key = disp['template_keys']
    r_sv = m[rsv_key]
    from scipy.signal import savgol_filter
    sv = savgol_filter(m[sv_key], disp.get('filter_window', 3),
                       disp.get('filter_order', 1))
    mu_avg = np.linspace(0.0, 1.0, 200)
    sv = sv / np.sum(trapezoid_weights(mu_avg) * sv[-1])

    x_v = np.linspace(-6.0, 6.0, n_v)
    mu_ap = np.linspace(1e-10, 1.0, 50)
    beta_data = d[rs['beta_key']] if rs.get('beta_key') in d \
        else m[real['beta_key']]
    s = d[rs['ccf_keys'][0]]
    data_vec = np.concatenate([d[k] for k in rs['ccf_keys'][1:]], axis=1)
    cov = c[cov_cfg['cov_key']]
    n_s = len(s)
    mu = np.linspace(0.0, 1.0, n_mu)
    return dict(
        iaH=iaH, sigma8_template=float(matter['template_sigma8']),
        nmocks=float(like['nmocks']),
        beta_real=m[real['beta_key']], xi0_pieces=pchip_pieces(
            m[real['beta_key']], xi0),
        r=r, K_r=not_a_knot_operator(r),
        r_v=r_v, K_v=not_a_knot_operator(r_v), Delta_rv=Delta_rv,
        r_sv=r_sv, sv=sv, sv_m=not_a_knot_operator(r_sv) @ sv,
        x_v=x_v, w_v=simpson_avg_weights(n_v, x_v[1] - x_v[0]),
        mu_ap=mu_ap, w_ap=trapezoid_weights(mu_ap),
        S=np.tile(s, n_mu), Mu=np.repeat(mu, n_s), n_s=n_s,
        mu=mu, K_mu=not_a_knot_operator(mu),
        mu_fine=np.linspace(0.0, 1.0, 200),
        beta_data=beta_data, data_pieces=pchip_pieces(beta_data, data_vec),
        beta_cov=c[cov_cfg['beta_key']] if cov_cfg.get('beta_key') in c
        else beta_data,
        cov=cov, icov=np.linalg.inv(cov))


# ---------------------------------------------------------------------------
# device: plain PyTorch, differentiable in the parameters
# ---------------------------------------------------------------------------

def _pick(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """v[idx] for a shared table v (n,), or row by row for v (B, n) and idx
    (B, ...)."""
    if v.dim() == 1:
        return v[idx]
    return torch.gather(v, 1, idx.reshape(v.shape[0], -1)).reshape(idx.shape)


def spline_at(x, y, m, q):
    """The cubic through (x, y) with second derivatives m at the knots, at
    q clamped into [x[0], x[-1]]. y and m are (n,) or (B, n); q is (B, ...)."""
    qc = torch.clamp(q, float(x[0]), float(x[-1]))
    i = torch.clamp(torch.bucketize(qc, x, right=True) - 1, 0, x.shape[0] - 2)
    x0, x1 = x[i], x[i + 1]
    h = x1 - x0
    a, b = x1 - qc, qc - x0
    y0, y1, m0, m1 = _pick(y, i), _pick(y, i + 1), _pick(m, i), _pick(m, i + 1)
    return (m0 * a ** 3 + m1 * b ** 3) / (6.0 * h) \
        + (y0 - m0 * h * h / 6.0) * a / h + (y1 - m1 * h * h / 6.0) * b / h


def pchip_at(x, pieces, q):
    """PCHIP pieces (n - 1, 4, ...) over x at q (B,): (B, ...); the end
    pieces extended beyond the grid."""
    q = q.contiguous()
    i = torch.clamp(torch.bucketize(q, x, right=True) - 1, 0, x.shape[0] - 2)
    t = (q - x[i]).reshape((-1,) + (1,) * (pieces.dim() - 2))
    c = pieces[i]
    return ((c[:, 0] * t + c[:, 1]) * t + c[:, 2]) * t + c[:, 3]


def chebyshev_matrix(degree: int) -> np.ndarray:
    """W (K, K), K = degree + 1: the coefficients of the interpolant through
    values f at the nodes cos((2k + 1) pi / (2K)) are W @ f (the discrete
    orthogonality of the Chebyshev polynomials at those nodes)."""
    K = degree + 1
    theta = (2 * np.arange(K) + 1) * np.pi / (2 * K)
    W = 2.0 / K * np.cos(np.outer(np.arange(K), theta))
    W[0] *= 0.5
    return W


def chebyshev_sum(c, u):
    """sum_j c[:, j] T_j(u) for c (B, K) and u (B, ...) in [-1, 1], by the
    three-term recurrence of T_j."""
    shape = (-1,) + (1,) * (u.dim() - 1)
    t_prev, t = torch.ones_like(u), u
    acc = c[:, 0].reshape(shape) + c[:, 1].reshape(shape) * u
    for j in range(2, c.shape[1]):
        t_prev, t = t, 2.0 * u * t - t_prev
        acc = acc + c[:, j].reshape(shape) * t
    return acc


class Model:
    """The model's ingredients on `device` as `dtype`, and its likelihood."""

    def __init__(self, config: Dict, device, dtype=torch.float64):
        self.device, self.dtype = torch.device(device), dtype
        host = host_arrays(config)
        self.n_s = int(host.pop('n_s'))
        self.iaH = host.pop('iaH')
        self.sigma8_template = host.pop('sigma8_template')
        self.nmocks = host.pop('nmocks')
        for k, v in host.items():
            setattr(self, k, torch.as_tensor(v, dtype=dtype, device=device))
        K = CHEB_DEGREE + 1
        nodes = np.cos((2 * np.arange(K) + 1) * np.pi / (2 * K))
        self.cheb_nodes = torch.as_tensor(nodes, dtype=dtype, device=device)
        self.cheb_W = torch.as_tensor(chebyshev_matrix(CHEB_DEGREE),
                                      dtype=dtype, device=device)

    # -- theory -------------------------------------------------------------

    def _fit_chebyshev(self, fn, lo, hi):
        q = 0.5 * (lo + hi)[:, None] + 0.5 * (hi - lo)[:, None] \
            * self.cheb_nodes
        return fn(q) @ self.cheb_W.T

    @staticmethod
    def _unit(lo, hi, q):
        """q (B, ...) mapped from [lo, hi] (B,) onto [-1, 1], clamped."""
        shape = (-1,) + (1,) * (q.dim() - 1)
        lo, hi = lo.reshape(shape), hi.reshape(shape)
        return torch.clamp((2.0 * q - (lo + hi)) / (hi - lo), -1.0, 1.0)

    def multipoles(self, p: Dict[str, torch.Tensor], streaming_eval: str):
        """Theory vector (B, 2 n_s): the monopole, then the quadrupole."""
        fs8, beta, sig, eps = (p[k] for k in PARAMS)
        B = fs8.shape[0]
        a_par = eps ** (-2.0 / 3.0)
        a_perp = eps * a_par
        resc = torch.sum(self.w_ap * a_par[:, None] * torch.sqrt(
            1.0 + (1.0 - self.mu_ap ** 2) * (eps ** 2 - 1.0)[:, None]), -1)
        iaH = self.iaH * a_par

        xi0 = pchip_at(self.beta_real, self.xi0_pieces, beta)     # (B, n_r)
        xi0_m = xi0 @ self.K_r.T
        vr = -(fs8 / self.sigma8_template)[:, None] * self.r_v \
            * self.Delta_rv / (3.0 * iaH[:, None])                # (B, n_rv)
        vr_m = vr @ self.K_v.T

        s_perp = self.S * torch.sqrt(1.0 - self.Mu ** 2) * a_perp[:, None]
        s_par = self.S * self.Mu * a_par[:, None]                 # (B, q)
        v = self.x_v[None, :, None] * sig[:, None, None]          # (B, n_v, 1)
        r_par = s_par[:, None, :] - v * iaH[:, None, None]
        rr = torch.sqrt(s_perp[:, None, :] ** 2 + r_par ** 2)     # (B, n_v, q)
        mu_r = r_par / rr
        r_t = rr / resc[:, None, None]
        if streaming_eval == 'fast':
            lo_v, hi_v = self.r_v[0] * resc, self.r_v[-1] * resc
            c_v = self._fit_chebyshev(lambda q: spline_at(
                self.r_v, vr, vr_m, q / resc[:, None]), lo_v, hi_v)
            lo_s, hi_s = self.r_sv[0] * resc, self.r_sv[-1] * resc
            c_s = self._fit_chebyshev(lambda q: spline_at(
                self.r_sv, self.sv, self.sv_m, q / resc[:, None]), lo_s, hi_s)
            mean = chebyshev_sum(c_v, self._unit(lo_v, hi_v, rr)) * mu_r
            disp = sig[:, None, None] * chebyshev_sum(
                c_s, self._unit(lo_s, hi_s, rr))
        else:
            mean = spline_at(self.r_v, vr, vr_m, r_t) * mu_r
            disp = sig[:, None, None] * spline_at(self.r_sv, self.sv,
                                                  self.sv_m, r_t)
        xi_r = spline_at(self.r, xi0, xi0_m, r_t)
        pdf = torch.exp(-0.5 * ((v - mean) / disp) ** 2) \
            / (math.sqrt(2.0 * math.pi) * disp)
        xi_s = sig[:, None] * torch.sum(
            (1.0 + xi_r) * pdf * self.w_v[None, :, None], 1) - 1.0    # (B, q)

        cols = xi_s.reshape(B, self.mu.shape[0], self.n_s).transpose(1, 2) \
            .reshape(B * self.n_s, -1)                        # (B n_s, n_mu)
        fine = spline_at(self.mu, cols, cols @ self.K_mu.T,
                         self.mu_fine.expand(cols.shape[0], -1))
        p2 = 0.5 * (3.0 * self.mu_fine ** 2 - 1.0)
        mono = torch.trapezoid(fine, self.mu_fine, dim=-1)
        quad = 5.0 * torch.trapezoid(fine * p2, self.mu_fine, dim=-1)
        return torch.cat([mono.reshape(B, self.n_s),
                          quad.reshape(B, self.n_s)], -1)

    # -- likelihood ---------------------------------------------------------

    def _blend(self, stack, beta):
        """The grid matrix below beta blended with the last grid matrix,
        weight t = (beta - g_low) / (g_last - g_low) on the last; the grid
        matrix at a node; the end matrices beyond the grid. (B, D, D)."""
        g, beta = self.beta_cov, beta.contiguous()
        n = g.shape[0]
        k = torch.clamp(torch.bucketize(beta, g, right=False), 0, n - 1)
        low = torch.clamp(k - 1, 0, n - 1)
        t = ((beta - g[low]) / (g[-1] - g[low]))[:, None, None]
        out = (1.0 - t) * stack[low] + t * stack[-1]
        out = torch.where((g[k] == beta)[:, None, None], stack[k], out)
        out = torch.where((beta <= g[0])[:, None, None], stack[0], out)
        return torch.where((beta >= g[-1])[:, None, None], stack[-1], out)

    def loglike(self, p: Dict[str, torch.Tensor], modes: Dict
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(lnL, chi^2), each (B,); (-inf, inf) where the blended covariance
        is not positive definite or the value is NaN."""
        streaming_eval = modes.get('streaming_eval', 'exact')
        _require(streaming_eval in STREAMING_EVAL and modes.get(
            'beta_covariance', 'exact') in BETA_COVARIANCE, f'modes {modes}')
        beta = p['beta']
        diff = self.multipoles(p, streaming_eval) - pchip_at(
            self.beta_data, self.data_pieces, beta).reshape(beta.shape[0], -1)
        icov = self._blend(self.icov, beta)
        chi2 = torch.einsum('bi,bij,bj->b', diff, icov, diff)
        sign, logdet = torch.linalg.slogdet(self._blend(self.cov, beta))
        lnl = -0.5 * self.nmocks * torch.log1p(chi2 / (self.nmocks - 1.0)) \
            - 0.5 * logdet
        bad = (sign <= 0) | torch.isnan(lnl)
        return (torch.where(bad, -math.inf, lnl),
                torch.where(bad, math.inf, chi2))
