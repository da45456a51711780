"""Excursion-set model (ESM) void density profiles, batched over parameter
points.

The port of `victor_tpu/models/esm.py:55-362` (the JAX re-design of the
reference ExcursionSetProfile, victor/excursion_set_profile.py, after
Massara & Sheth arXiv:1811.03132). Every function takes the parameters as a
dict of (B,) tensors, so each batch row has its own cosmology, P(k),
Eulerian radius grid and profile spline:

  * P(k) lives on the fixed 200-point log k grid of the tables; the s_j
    variance integrals are trapezoid contractions over it, (B, n, nk) @ (nk,);
  * the Eulerian radii differ per row, so the profile spline has per-row
    knots: `ops.cubic_coeffs_dynamic` solves one (n, n) not-a-knot system per
    row and `ops.ppoly_eval_dynamic` evaluates it;
  * the shell-crossing / NaN cleanup of the reference
    (excursion_set_profile.py:347-362) is `_masked_monotone_interp`, a masked
    re-sort with fixed shapes, bit-identical to the reference's deletion in
    the regular (no shell crossing) regime.

P(k) is Eisenstein-Hu computed per row, a pregenerated CAMB table, or the
multilinear interpolation of a grid of CAMB tables over named cosmology axes.
The nonlinear velocity is the *intended* density_evolution: the reference's
is unreachable (`model_1halo` unbound at excursion_set_profile.py:460).

`ExcursionSetProfile` is the host-side class with the reference surface over
these functions, one parameter point (B = 1) per call.
"""

from __future__ import annotations

import itertools
import math
import types

import numpy as np
import torch

from ..ops.special import clip, growth_factor_lcdm, ipow
from ..ops.splines import (cubic_coeffs_dynamic, gradient_nonuniform,
                           ppoly_eval_dynamic)
from .ccf_theory import _param
from .eisenstein_hu import (eisenstein_hu_params, power_eh, sigma80,
                            tophat_window)

TWO_PI2 = 2.0 * math.pi ** 2

# parameter defaults shared by the EH branch and the grid-interpolation
# branch (set_ESM_params, victor/ccf_model.py:494-536): an axis parameter a
# chain holds fixed interpolates at the value EH mode would use
_ESM_COSMO_DEFAULTS = {'H0': 67.5, 'Omega_m': 0.31, 'Omega_b': 0.048,
                       'ns': 0.96}


def _col(v):
    """A (B,) tensor shaped to broadcast against (B, n) rows."""
    return v[:, None]


# ---------------------------------------------------------------------------
# cosmology-dependent state
# ---------------------------------------------------------------------------

def esm_growth_factor(z, omega_m, omega_l):
    """D(z)/D(0) closed form (excursion_set_profile.py:106-119), the one of
    `ops.special.growth_factor_lcdm`."""
    return growth_factor_lcdm(z, omega_m, omega_l)


def _esm_grid_interp(tables, spec, params):
    """Multilinear interpolation of the cosmology-grid P(k) tables
    (victor_tpu/models/esm.py:69-118), per batch row.

    `tables.esm_pk_grid` holds log P(k, z=0) at every point of a grid over the
    axes named in `spec.esm_grid_names`, flattened to (n_cells, nk), with the
    generator's sigma8(0) and sigma8(z_eff) as (n_cells,) tables. Each row
    interpolates linearly in log P(k) over its 2^A grid corners, with the
    parameters clamped to the grid hull. Returns (pk0 (B, nk), s80_fid (B,),
    s8z_fid (B,)), the un-normalised pieces that `esm_state` rescales."""
    axes, names = tables.esm_grid_axes, spec.esm_grid_names
    shape = tuple(int(g.shape[0]) for g in axes)
    like = next(iter(params.values()))
    los, ts = [], []
    for g, name in zip(axes, names):
        x = _param(params, name, _ESM_COSMO_DEFAULTS.get(name, 0.0))
        n = g.shape[0]
        if n == 1:      # singleton axis: no interpolation, weight-0 corner
            los.append(torch.zeros_like(x, dtype=torch.long))
            ts.append(torch.zeros_like(x))
            continue
        kidx = torch.searchsorted(g, x, right=False)
        lo = torch.clamp(kidx - 1, 0, n - 2)
        t = (x - g[lo]) / (g[lo + 1] - g[lo])
        los.append(lo)
        ts.append(clip(t, 0.0, 1.0))      # clamp outside the grid hull
    logpk = torch.zeros(like.shape + tables.esm_pk_grid.shape[-1:],
                        dtype=like.dtype, device=like.device)
    s80 = torch.zeros_like(like)
    s8z = torch.zeros_like(like)
    for corner in itertools.product((0, 1), repeat=len(shape)):
        w = torch.ones_like(like)
        flat = torch.zeros_like(like, dtype=torch.long)
        for a, c in enumerate(corner):
            w = w * (ts[a] if c else 1.0 - ts[a])
            # singleton axes only contribute their c=0 corner (t = 0 zeroes
            # the c=1 weight); the clamp keeps the dead index in bounds
            flat = flat * shape[a] + torch.clamp(los[a] + c, max=shape[a] - 1)
        logpk = logpk + _col(w) * tables.esm_pk_grid[flat]
        s80 = s80 + w * tables.esm_s80_grid[flat]
        s8z = s8z + w * tables.esm_s8z_grid[flat]
    return torch.exp(logpk), s80, s8z


def esm_state(tables, spec, params):
    """The normalised z=0 power spectrum and growth of each batch row.

    Parameter defaults follow set_ESM_params (victor/ccf_model.py:494-536).
    Returns a dict of k (nk,), kw (nk,) trapezoid weights, pk (B, nk)
    normalised P(k, 0), Dz (B,), s8z (B,) sigma8 at z_eff after
    normalisation, and delta_c (B,)."""
    omm = _param(params, 'Omega_m', _ESM_COSMO_DEFAULTS['Omega_m'])
    omk = _param(params, 'Omega_k', 0.0)
    oml = 1.0 - omm - omk
    s80 = _param(params, 'sigma_8_0', 0.81)
    k = tables.esm_k
    Dz = esm_growth_factor(tables.z_eff, omm, oml)
    if spec.esm_use_eh:
        h = _param(params, 'H0', _ESM_COSMO_DEFAULTS['H0']) / 100.0
        omb = _param(params, 'Omega_b', _ESM_COSMO_DEFAULTS['Omega_b'])
        ns = _param(params, 'ns', _ESM_COSMO_DEFAULTS['ns'])
        p = eisenstein_hu_params(h, omm, omb, ns=ns, As=2e-9)
        pk0 = power_eh(p, k)
        s80_fid = sigma80(p)
        s8z_fid = s80_fid * Dz
    elif tables.esm_pk_grid is not None:
        pk0, s80_fid, s8z_fid = _esm_grid_interp(tables, spec, params)
    else:
        pk0 = tables.esm_pk0.expand(s80.shape + k.shape)
        s80_fid = tables.esm_s80
        s8z_fid = tables.esm_s8z
    norm = ipow(s80 / s80_fid, 2)
    return {'k': k, 'kw': tables.esm_kw, 'pk': pk0 * _col(norm), 'Dz': Dz,
            's8z': s8z_fid * torch.sqrt(norm),
            'delta_c': _param(params, 'delta_c', 1.686)}


# ---------------------------------------------------------------------------
# window functions and variance integrals (excursion_set_profile.py:159-214)
# ---------------------------------------------------------------------------

def _w_cut(k, R, Rx):
    """Top-hat window with a Gaussian cut: k (nk,), R and Rx broadcast."""
    return tophat_window(k * R) * torch.exp(-0.5 * ipow(k * R / Rx, 2))


def _sj_pq(st, Rp, Rq, Rx, j=0):
    """Cross variance s_j^{pq}: Rp, Rx (B,), Rq (B, n) or (n,) -> (B, n)."""
    k, kw, pk = st['k'], st['kw'], st['pk']
    Rq = Rq.expand(Rp.shape + Rq.shape[-1:])
    integ = (ipow(k, 2 + 2 * j) * pk * _w_cut(k, _col(Rp), _col(Rx)))[:, None, :] \
        * tophat_window(Rq[..., None] * k) / TWO_PI2
    return torch.matmul(integ, kw)


def _sj_pp(st, Rp, Rx, j=0):
    """Auto variance s_j^{pp}: (B,)."""
    k, kw, pk = st['k'], st['kw'], st['pk']
    integ = ipow(k, 2 + 2 * j) * pk * \
        ipow(_w_cut(k, _col(Rp), _col(Rx)), 2) / TWO_PI2
    return torch.matmul(integ, kw)


def _s0_derivative_term(st, Rp, Rq, Rx):
    """d s0_pq / d s0_pp by 5-point central differences
    (excursion_set_profile.py:206-214): (B, n)."""
    step = 0.01 * Rp
    rp = [Rp + c * step for c in (-2.0, -1.0, 1.0, 2.0)]
    d_pq = (-_sj_pq(st, rp[3], Rq, Rx) + 8.0 * _sj_pq(st, rp[2], Rq, Rx)
            - 8.0 * _sj_pq(st, rp[1], Rq, Rx) + _sj_pq(st, rp[0], Rq, Rx)) \
        / _col(12.0 * step)
    d_pp = (-_sj_pp(st, rp[3], Rx) + 8.0 * _sj_pp(st, rp[2], Rx)
            - 8.0 * _sj_pp(st, rp[1], Rx) + _sj_pp(st, rp[0], Rx)) \
        / (12.0 * step)
    return d_pq / _col(d_pp)


def lagrangian_profile(st, Rq, b10, b01, Rp, Rx):
    """Excursion-set Lagrangian enclosed density
    (excursion_set_profile.py:216-237): (B, n)."""
    return _col(b10) * _sj_pq(st, Rp, Rq, Rx) + \
        _col(b01 * 2.0 * _sj_pp(st, Rp, Rx)) * _s0_derivative_term(st, Rp, Rq,
                                                                   Rx)


def eulerian_1halo(st, r_lagrange, b10, b01, Rp, Rx):
    """Spherical-evolution (1-halo) term and Eulerian radii
    (excursion_set_profile.py:239-278), each (B, n). Shell-crossed radii come
    out NaN."""
    DeltaL = lagrangian_profile(st, r_lagrange, b10, b01, Rp, Rx)
    dc = _col(st['delta_c'])
    one_halo = (1.0 - _col(st['Dz']) * DeltaL / dc) ** (-dc) - 1.0
    r_euler = r_lagrange / (1.0 + one_halo) ** (1.0 / 3.0)
    return r_euler, one_halo


def eulerian_2halo(st, r_euler, Rp, Rx):
    """Void-motion (2-halo) term at Eulerian radii (B, n)
    (excursion_set_profile.py:280-307)."""
    k, kw, pk = st['k'], st['kw'], st['pk']
    s0 = _sj_pp(st, Rp, Rx, j=0)
    s1 = _sj_pp(st, Rp, Rx, j=1)
    bv = 1.0 - ipow(k, 2) * _col(s0 / s1)
    base = bv * _w_cut(k, _col(Rp), _col(Rx)) * pk * ipow(k, 2) / TWO_PI2
    integ = base[:, None, :] * tophat_window(r_euler[..., None] * k)
    return torch.matmul(integ, kw)


# ---------------------------------------------------------------------------
# masked monotone cleanup + dynamic spline (fixed-shape shell-crossing repair)
# ---------------------------------------------------------------------------

def _masked_monotone_interp(r_euler, values, queries, clamp=False):
    """Interpolate each row's (r_euler, values) at `queries` after the
    reference's NaN / shell-crossing cleanup (excursion_set_profile.py:
    347-362), with fixed shapes: r_euler and values (B, n), queries (B, m) or
    (m,) -> (B, m).

    A point survives iff it is finite and strictly below every later radius
    (reverse running minimum); in the regular monotone regime that keeps
    everything and reproduces IUS(r_euler, values) exactly. Dropped points
    are re-sorted past the largest kept radius with constant value
    continuation, where they cannot influence in-range evaluation beyond
    spline end effects."""
    n = r_euler.shape[-1]
    finite = torch.isfinite(r_euler) & torch.isfinite(values)
    key = torch.where(finite, r_euler, torch.inf)
    revmin_incl = torch.flip(torch.cummin(torch.flip(key, [-1]), -1).values,
                             [-1])
    revmin_excl = torch.cat([revmin_incl[..., 1:],
                             torch.full_like(key[..., :1], torch.inf)], -1)
    keep = finite & (key < revmin_excl)

    order = torch.argsort(torch.where(keep, key, torch.inf), dim=-1,
                          stable=True)
    re_s = torch.gather(key, -1, order)
    val_s = torch.gather(values, -1, order)
    n_keep = keep.sum(-1, keepdim=True)
    last = torch.clamp(n_keep - 1, min=0)
    last_re = torch.gather(re_s, -1, last)
    last_val = torch.gather(val_s, -1, last)
    i = torch.arange(n, device=key.device)
    re_p = torch.where(i < n_keep, re_s,
                       last_re + (i - n_keep + 1).to(key.dtype))
    val_p = torch.where(i < n_keep, val_s, last_val)

    coeffs = cubic_coeffs_dynamic(re_p, val_p)
    q = queries.expand(re_p.shape[:-1] + queries.shape[-1:])
    return ppoly_eval_dynamic(re_p, coeffs, q, clamp=clamp)


# ---------------------------------------------------------------------------
# hooks consumed by the theory core
# ---------------------------------------------------------------------------

def enclosed_profile_at(tables, spec, params, queries):
    """Eulerian enclosed density Delta(r) at `queries` (m,) or (B, m)
    (model_enclosed_density_profile, excursion_set_profile.py:309-371):
    (B, m)."""
    st = esm_state(tables, spec, params)
    b10, b01 = params['b10'], params['b01']
    Rp, Rx = params['Rp'], params['Rx']
    r_euler, one_halo = eulerian_1halo(st, tables.r_v, b10, b01, Rp, Rx)
    two_halo = eulerian_2halo(st, r_euler, Rp, Rx)
    model_full = one_halo + _col(ipow(st['Dz'], 2)) * two_halo
    return _masked_monotone_interp(r_euler, model_full, queries, clamp=False)


def esm_delta_profiles(tables, spec, opts, params):
    """(delta_rv, Delta_rv, delta_100, Delta_100), each (B, n), for the
    theory core (victor/ccf_model.py:373-381 and the respline at :421-423).
    The respline evaluates both profiles in one two-channel lookup."""
    r_v = tables.r_v
    Delta_rv = enclosed_profile_at(tables, spec, params, r_v)
    deriv = gradient_nonuniform(Delta_rv, r_v)
    delta_rv = Delta_rv + r_v * deriv / 3.0
    # velocity_terms resplines the node values over r_v with ext=3 and
    # evaluates on the fine grid (ccf_model.py:421-423,456-459)
    c = tables.spline_vel.coeffs(torch.stack([delta_rv, Delta_rv], 1))
    r100 = tables.rgrid100.expand(Delta_rv.shape[0], -1)
    out = tables.spline_vel.eval_multi(c, r100)       # (B, 2, 100)
    return delta_rv, Delta_rv, out[:, 0], out[:, 1]


def density_evolution_at(tables, spec, params, queries, pairwise=False):
    """(1/f) dDelta/dln a at `queries` (m,): (B, m), the *intended*
    density_evolution (excursion_set_profile.py:412-486; the reference's is
    unreachable, see the module docstring)."""
    st = esm_state(tables, spec, params)
    b10, b01 = params['b10'], params['b01']
    Rp, Rx = params['Rp'], params['Rx']
    r_euler, dSph = eulerian_1halo(st, tables.esm_x50, b10, b01, Rp, Rx)
    # clean, then work on the cleaned grid: the 1-halo term and its gradient
    # by the same masked interpolation, the 2-halo term at the queries
    dSph_q = _masked_monotone_interp(r_euler, dSph, queries, clamp=False)
    grad_nodes = gradient_nonuniform(dSph, r_euler)
    dSph_deriv_q = _masked_monotone_interp(r_euler, grad_nodes, queries,
                                           clamp=False)
    Dz = _col(st['Dz'])
    q = queries.expand(r_euler.shape[:-1] + queries.shape[-1:])
    delta2_q = Dz * eulerian_2halo(st, q, Rp, Rx)
    dc = _col(st['delta_c'])
    factor = 2.0 if pairwise else 1.0
    return dc * (1.0 + dSph_q + queries * dSph_deriv_q / 3.0) * \
        ((1.0 + dSph_q) ** (1.0 / dc) - 1.0) + factor * Dz * delta2_q


def esm_velocity_terms(tables, spec, opts, params, growth_term, iaH_true,
                       delta_rv, delta_100):
    """Nonlinear mean velocity from the ESM evolution term
    (victor/ccf_model.py:460-482): (vr (B, n_rv), dvr (B, n_rv)).
    `growth_term` is f, `iaH_true` the true 1/(aH), both (B, 1)."""
    r_v, r100 = tables.r_v, tables.rgrid100
    # one evaluation over the concatenated query points: the evolution term
    # is pointwise in the queries
    ld = density_evolution_at(tables, spec, params, torch.cat([r_v, r100]))
    ld_rv, ld_100 = ld[:, :r_v.shape[0]], ld[:, r_v.shape[0]:]
    if not opts.empirical_corr:
        vr = -growth_term * r_v * ld_rv / (3.0 * iaH_true * (1.0 + delta_rv))
    else:
        Av = _param(params, 'Av', 0.0)[:, None]
        vr = -growth_term * r_v * ld_rv * (1.0 + Av * delta_rv) / \
            (3.0 * iaH_true * (1.0 + delta_rv))
    # the reference's fine-grid derivative omits the empirical correction
    # factor (ccf_model.py:470-482): reproduced for parity
    vr_100 = -growth_term * r100 * ld_100 / (3.0 * iaH_true * (1.0 + delta_100))
    return vr, vr_100 @ tables.dvr_op.T


def esm_s8z(tables, spec, params):
    """sigma8(z_eff) after normalisation, (B,): the derived quantity behind
    fsigma8 = f * s8z (victor/ccf_model.py:530-532, CCFLikelihood.py:40-42)."""
    return esm_state(tables, spec, params)['s8z']


# ---------------------------------------------------------------------------
# class wrapper with the reference surface (victor/excursion_set_profile.py:6)
# ---------------------------------------------------------------------------

class ExcursionSetProfile:
    """Standalone class API mirroring the reference ExcursionSetProfile
    (victor_tpu/models/esm.py:364-511).

    A host-side wrapper over the functions above at one parameter point
    (B = 1), its tables on `device` (the card unless 'cpu' is asked for) in
    `dtype`. The profile methods return callables, evaluated on the device
    per call, matching the reference's returned scipy interpolators; each
    snapshots its own call's z and x grid. `model_density_profile` and
    `density_evolution` implement the intended behaviour (both are broken or
    unreachable in the reference; SURVEY.md §2b).
    """

    def __init__(self, h, omega_m, omega_b, z=0, ns=0.965, omega_k=0,
                 mnu=0.06, npts=200, use_eisenstein_hu=True, camb_accuracy=1,
                 pk_table=None, *, device='cuda', dtype=torch.float64):
        from .. import ops as _ops
        from ..io.tables import _target_device

        self.device, self.dtype = _target_device(device), dtype
        self.omega_m = omega_m
        self.omega_b = omega_b
        self.omega_l = 1 - omega_m - omega_k
        self.z = z
        k = np.logspace(-4, np.log10(2), npts)
        tbl = dict(z_eff=self._t(float(z)), esm_k=self._t(k),
                   esm_kw=self._t(_ops.trapz_weights(k)), esm_pk0=None,
                   esm_s80=None, esm_s8z=None, esm_x50=None,
                   esm_pk_grid=None)
        use_eh = use_eisenstein_hu
        if not use_eh and pk_table is not None:
            # resample onto this instance's k grid (the table may have been
            # generated with a different npts/kmax): the cubic-spline
            # ingestion of io/tables.py
            from scipy.interpolate import InterpolatedUnivariateSpline as IUS
            tbl['esm_pk0'] = self._t(IUS(np.asarray(pk_table['k']),
                                         np.asarray(pk_table['pk0']), k=3)(k))
            tbl['esm_s80'] = self._t(float(pk_table['sigma8_0']))
            tbl['esm_s8z'] = self._t(float(pk_table['sigma8_z']))
        elif not use_eh:
            # the reference prints a fallback warning when camb is absent
            # (excursion_set_profile.py:63-70); here the CAMB path is a
            # precomputed pk_table (tools/make_camb_table.py): falling back
            # silently would hand out percent-level-different P(k)
            from ..utils.logging import get_logger
            get_logger('esm').warning(
                'use_eisenstein_hu=False requires pk_table= (generate one '
                'with tools/make_camb_table.py); falling back to the '
                'Eisenstein-Hu fitting formula')
            use_eh = True
        self._tables = types.SimpleNamespace(**tbl)
        self._spec = types.SimpleNamespace(esm_use_eh=use_eh)
        self._base = {'H0': h * 100.0, 'Omega_m': omega_m, 'Omega_b': omega_b,
                      'ns': ns, 'Omega_k': omega_k}
        st = esm_state(self._tables, self._spec,
                       self._tp({**self._base, 'sigma_8_0': 1.0}))
        # fiducial (un-normalised) sigma8 values, reference attribute names
        if use_eh:
            p = eisenstein_hu_params(*(self._t([v]) for v in
                                       (h, omega_m, omega_b, ns)), As=2e-9)
            self.s80_fiducial = float(sigma80(p)[0])
            self.s8z_fiducial = self.s80_fiducial * float(st['Dz'][0])
        else:
            self.s80_fiducial = float(pk_table['sigma8_0'])
            self.s8z_fiducial = float(pk_table['sigma8_z'])
        self.normalisation = 1.0
        self._sigma8 = None
        self.use_eisenstein_hu = use_eh

    def _t(self, v) -> torch.Tensor:
        return torch.as_tensor(v, dtype=self.dtype, device=self.device)

    def _tp(self, params) -> dict:
        """A parameter point as the functions above take it: (1,) tensors."""
        return {k: self._t(v).reshape(1) for k, v in params.items()}

    def _snapshot(self, **fields):
        """The tables with this call's fields: a returned callable must not
        alias instance state (the reference returns snapshot scipy splines;
        a later call with another z must not change profiles handed out
        earlier)."""
        return types.SimpleNamespace(**{**vars(self._tables), **fields})

    # -- reference methods ------------------------------------------------
    def growth_factor(self, z):
        return float(esm_growth_factor(self._t(float(z)), self.omega_m,
                                       self.omega_l))

    def set_normalisation(self, sigma8, z=0):
        if z == 0:
            self.normalisation = (sigma8 / self.s80_fiducial) ** 2
            self._sigma8 = sigma8
        else:
            self.normalisation = (sigma8 / self.s8z_fiducial) ** 2
            self._sigma8 = sigma8 * self.s80_fiducial / self.s8z_fiducial

    def _params(self, b10, b01, Rp, Rx, delta_c=1.686):
        s80 = self._sigma8 if self._sigma8 is not None else self.s80_fiducial
        return self._tp({**self._base, 'sigma_8_0': s80, 'b10': b10,
                         'b01': b01, 'Rp': Rp, 'Rx': Rx, 'delta_c': delta_c})

    def power(self, k, z):
        st = esm_state(self._tables, self._spec,
                       self._tp({**self._base,
                                 'sigma_8_0': self.s80_fiducial}))  # un-normalised
        D = esm_growth_factor(self._t(float(z)), self.omega_m, self.omega_l)
        coeffs = cubic_coeffs_dynamic(st['k'], st['pk'][0])
        q = self._t(np.asarray(k, dtype=float))
        out = ppoly_eval_dynamic(st['k'][None], coeffs[None],
                                 q.reshape(1, -1))[0] * ipow(D, 2)
        return out.reshape(q.shape).cpu().numpy()

    def model_enclosed_density_profile(self, r, z, b10, b01, Rp, Rx,
                                       delta_c=1.686):
        t = self._snapshot(z_eff=self._t(float(z)))
        params = self._params(b10, b01, Rp, Rx, delta_c)
        spec = self._spec
        r = self._t(np.atleast_1d(np.asarray(r, dtype=float)))

        def profile(q):
            # the module pipeline with r as the Lagrangian grid
            st = esm_state(t, spec, params)
            re_, oneh = eulerian_1halo(st, r, params['b10'], params['b01'],
                                       params['Rp'], params['Rx'])
            two = eulerian_2halo(st, re_, params['Rp'], params['Rx'])
            model = oneh + _col(ipow(st['Dz'], 2)) * two
            qt = self._t(np.atleast_1d(np.asarray(q, dtype=float)))
            return _masked_monotone_interp(re_, model, qt)[0].cpu().numpy()
        return profile

    def model_density_profile(self, r, z, b10, b01, Rp, Rx, delta_c=1.686):
        enclosed = self.model_enclosed_density_profile(r, z, b10, b01, Rp, Rx,
                                                       delta_c)
        r = np.atleast_1d(np.asarray(r, dtype=float))
        vals = enclosed(r)
        deriv = np.gradient(vals, r)
        from scipy.interpolate import InterpolatedUnivariateSpline as IUS
        return IUS(r, vals + r * deriv / 3.0)

    def density_evolution(self, z, b10, b01, Rp, Rx, delta_c=1.686,
                          r_max=120, pairwise=False):
        t = self._snapshot(z_eff=self._t(float(z)),
                           esm_x50=self._t(np.linspace(0.1, r_max, 50)))
        params = self._params(b10, b01, Rp, Rx, delta_c)
        spec = self._spec

        def fn(q):
            qt = self._t(np.atleast_1d(np.asarray(q, dtype=float)))
            return density_evolution_at(t, spec, params, qt,
                                        pairwise=pairwise)[0].cpu().numpy()
        return fn
