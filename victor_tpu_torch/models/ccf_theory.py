"""CCF theory: the real-space to redshift-space mapping, batched.

The port of `victor_tpu/models/ccf_theory.py`, every option of it: the RSD
models 'streaming' (victor/ccf_model.py:649-657), 'dispersion' (:658-671),
'kaiser' with the M/Q nuisances, the approximation and coordinate-shift
toggles (:692-741) and 'euclid_special' (:743-784); the matter models
'template', 'linear_bias' and 'excursion_set' (models/esm.py); the mean
velocity models 'linear' (with or without `empirical_corr`), 'template' and
'nonlinear' (ESM); isotropic or anisotropic real-space input; the
data-derived real-space mode `realspace_ccf_from_data`; both AP
template-rescaling modes; and the perf modes of the streaming and dispersion
models (`streaming_eval`, `dispersion_interior`, `dispersion_final`).

Parameters are a dict of (B,) tensors. With q = n_mu * n_s flattened (mu
leading) and n_v velocity nodes, the intermediates are (B, n_v, q) for the
models with a velocity integral and (B, q) for kaiser and euclid_special.
Each exact spline lookup is one call of `ops.ppoly_eval` (one table) or
`ops.ppoly_eval_multi` (v_r with dv_r, or the real-space multipoles, over
one query set), and the fused dispersion final stage one call of
`ops.dispersion_final`; all run CUDA kernels on the card.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch

from ..config import RSD_MODELS, TableSpec, TheoryOptions
from ..errors import InputError
from ..ops.legendre import legendre_p
from ..ops.splines import (chebyshev_eval, chebyshev_eval_multi, chebyshev_fit,
                           dispersion_final, pchip_eval)

SQRT2PI = 2.5066282746310002


def _param(params, key, default):
    """params[key], or `default` (a number or a 0-d tensor) broadcast to the
    batch shape."""
    if key in params:
        return params[key]
    like = next(iter(params.values()))
    if isinstance(default, torch.Tensor):
        return default.to(like).expand_as(like)
    return torch.full_like(like, default)


def resolve_ap(params):
    """AP parameter resolution (victor/ccf_model.py:589-596): (epsilon,
    aperp, apar), each (B,)."""
    if 'epsilon' in params:
        epsilon = params['epsilon']
        apar = _param(params, 'alpha', 1.0) * epsilon ** (-2.0 / 3.0)
        aperp = epsilon * apar
    else:
        aperp = _param(params, 'aperp', 1.0)
        apar = _param(params, 'apar', 1.0)
        epsilon = aperp / apar
    return epsilon, aperp, apar


def real_multipoles(tables, spec: TableSpec, beta):
    """Interpolated real-space multipoles (B, n_ell, n_r)
    (victor/ccf_model.py:299-326)."""
    if spec.fixed_real_input:
        return tables.real_mult_fixed.expand(beta.shape[0], -1, -1)
    return pchip_eval(tables.beta_grid, tables.real_mult_pchip_c, beta)


def delta_profiles(tables, spec: TableSpec, opts: TheoryOptions, params):
    """Matter-density monopole and its enclosed integral at the r_v and
    rgrid100 nodes (victor/ccf_model.py:328-383): (delta_rv, Delta_rv,
    delta_100, Delta_100), shared by the whole batch for the template and
    (B, n) per row for the linear-bias and excursion-set models."""
    if opts.matter_model == 'template':
        return (tables.delta_rv, tables.Delta_rv,
                tables.delta_r100, tables.Delta_r100)
    if opts.matter_model == 'linear_bias':
        bias = _param(params, 'bias', tables.bias_default)[:, None]
        if 'beta' not in params and not spec.fixed_real_input:
            # the reference raises through get_interpolated_real_multipoles
            # (ccf_model.py:321-322); a 0.0 default would silently
            # extrapolate the beta-interpolated multipoles off the grid
            raise InputError('Need to supply a valid value of beta for '
                             'interpolation')
        beta = _param(params, 'beta', 0.0)
        y0 = real_multipoles(tables, spec, beta)[:, 0]           # (B, n_r)
        return tuple(y0 @ op.T / bias for op in (
            tables.lb_delta_op, tables.lb_Delta_op, tables.lb_delta100_op,
            tables.lb_Delta100_op))
    if opts.matter_model == 'excursion_set':
        from .excursion_set import esm_delta_profiles
        return esm_delta_profiles(tables, spec, opts, params)
    raise InputError(f'Invalid choice of matter_model {opts.matter_model}')


def velocity_terms(tables, spec: TableSpec, opts: TheoryOptions, params):
    """Mean radial velocity v_r and dv_r/dr at the r_v nodes, each (B, n_rv)
    (victor/ccf_model.py:385-492), multiplied by the true 1/(aH). The growth
    term is resolved sequentially, not as an elif chain, as the reference
    does: a template mean overrides the matter model's."""
    _, _, apar = resolve_ap(params)
    iaH_true = (tables.iaH * apar)[:, None]
    delta_rv, Delta_rv, delta_100, Delta_100 = delta_profiles(tables, spec,
                                                              opts, params)
    # delta_profiles has raised for an unknown matter model
    if opts.matter_model == 'linear_bias':
        if opts.realspace_ccf_from_data:
            growth_term = params['beta'] * _param(params, 'bias',
                                                  tables.bias_default)
        else:
            growth_term = params['fsigma8'] / tables.template_sigma8
    if opts.matter_model == 'template':
        growth_term = params['fsigma8'] / tables.template_sigma8
    if opts.matter_model == 'excursion_set':
        growth_term = params['f']
    if opts.mean_model == 'template':
        if not spec.has_velocity_template:
            raise InputError('velocity_terms: Cannot use template option as no '
                             'template has been supplied.')
        growth_term = (params['fsigma8'] / tables.template_fsigma8) * \
            tables.template_hubble_ratio * tables.redshift_shift / apar
    growth_term = growth_term[:, None]

    r_v, r100 = tables.r_v, tables.rgrid100
    if opts.mean_model == 'linear':
        if not opts.empirical_corr:
            vr = -growth_term * r_v * Delta_rv / (3.0 * iaH_true)
            dvr = -growth_term * (delta_rv - 2.0 * Delta_rv / 3.0) / iaH_true
        else:
            Av = _param(params, 'Av', 0.0)[:, None]
            vr = -growth_term * r_v * Delta_rv * (1.0 + Av * delta_rv) / (3.0 * iaH_true)
            vr100 = -growth_term * r100 * Delta_100 * (1.0 + Av * delta_100) / (3.0 * iaH_true)
            dvr = vr100 @ tables.dvr_op.T
    elif opts.mean_model == 'nonlinear':
        from .excursion_set import esm_velocity_terms
        vr, dvr = esm_velocity_terms(tables, spec, opts, params, growth_term,
                                     iaH_true, delta_rv, delta_100)
    elif opts.mean_model == 'template':
        vr = tables.vr_template_rv * growth_term
        dvr = (tables.vr_template_100 * growth_term) @ tables.dvr_op.T
    else:
        raise InputError(f'Invalid choice of mean_model {opts.mean_model}')
    return vr, dvr


def theory_xi_grid(tables, spec: TableSpec, opts: TheoryOptions, params,
                   s: Optional[torch.Tensor] = None,
                   mu: Optional[torch.Tensor] = None):
    """Redshift-space xi(s, mu) on the (n_mu, n_s) outer-product grid:
    (B, n_mu, n_s) (victor/ccf_model.py:538-789)."""
    s = tables.s if s is None else s
    mu = tables.mu_grid if mu is None else mu
    n_mu, n_s = mu.shape[0], s.shape[0]
    S = s[None, :].expand(n_mu, n_s).reshape(-1)
    Mu = mu[:, None].expand(n_mu, n_s).reshape(-1)
    xi = theory_xi_points(tables, spec, opts, params, S, Mu)
    return xi.reshape(-1, n_mu, n_s)


def _per_row(v, q):
    """A (B,) tensor shaped to broadcast against q of shape (B, ...)."""
    return v.reshape((-1,) + (1,) * (q.ndim - 1))


def theory_xi_points(tables, spec: TableSpec, opts: TheoryOptions, params,
                     S: torch.Tensor, Mu: torch.Tensor):
    """Redshift-space xi at paired points (S, Mu), both flat (q,): (B, q)."""
    if opts.rsd_model not in RSD_MODELS:
        raise InputError(f'theory_xi: Unrecognised choice of model {opts.rsd_model}')

    # --- scalar parameter resolution, each (B,) ---
    epsilon, aperp, apar = resolve_ap(params)
    if spec.fixed_real_input and opts.matter_model != 'linear_bias':
        beta = torch.full_like(apar, 0.40)   # irrelevant (ccf_model.py:583-585)
    else:
        beta = params['beta']
    iaH_true = tables.iaH * apar

    # AP rescaling of templates (ccf_model.py:606-613)
    if opts.velocity_independent_of_AP:
        resc = _param(params, 'astar', 1.0)
    else:
        integrand = apar[:, None] * torch.sqrt(
            1.0 + (1.0 - tables.mu_ap ** 2) * (epsilon ** 2 - 1.0)[:, None])
        resc = torch.sum(tables.mu_ap_w * integrand, dim=-1)
    # the excursion-set model predicts the absolute scale, so its velocity
    # templates are not rescaled (ccf_model.py:626-632)
    resc_vel = torch.ones_like(resc) if opts.matter_model == 'excursion_set' \
        else resc

    # --- table-dependent coefficients ---
    y_mult = real_multipoles(tables, spec, beta)          # (B, n_ell, n_r)
    if opts.assume_isotropic:
        y_mult = y_mult[:, :1]                            # the monopole only
    c_mult = tables.spline_mult.coeffs(y_mult)            # (B, n_ell, n_r-1, 4)
    vr, dvr = velocity_terms(tables, spec, opts, params)
    c_vr = tables.spline_vel.coeffs(vr)                   # (B, n_rv-1, 4)
    c_dvr = None if opts.rsd_model == 'streaming' \
        else tables.spline_vel.coeffs(dvr)

    def vr_at(q):
        return tables.spline_vel.eval(c_vr, q / _per_row(resc_vel, q))

    def vr_dvr_at(q):
        """(v_r, dv_r/dr) at the same points: one two-channel lookup, one
        interval search (victor_tpu makes two lookups; the same values)."""
        rv = _per_row(resc_vel, q)
        out = tables.spline_vel.eval_multi(torch.stack([c_vr, c_dvr], 1),
                                           q / rv)
        return out[:, 0], out[:, 1] / rv

    def xi_real(r_eval, mu):
        """Real-space xi at (r, mu_r), r on the splines' own scale
        (ccf_model.py:616-621,673-687): the monopole, or one multi-channel
        lookup of every multipole summed against the Legendre
        polynomials."""
        if opts.assume_isotropic:
            return tables.spline_mult.eval(c_mult[:, 0], r_eval)
        vals = tables.spline_mult.eval_multi(c_mult, r_eval)   # (B, n_ell, ...)
        out = torch.zeros_like(r_eval)
        for i, ell in enumerate(spec.poles_r):
            out = out + vals[:, i] * legendre_p(ell, mu)
        return out

    def xi_at(r_par, r_eval, mu_r, s_perp):
        """xi_real at the model's real-space coordinates: r_eval = r / resc
        on the rescaled templates, or for a data-derived real-space CCF the
        inverse-AP shift of (r_par, s_perp) back to fiducial coordinates with
        unrescaled r (ccf_model.py:673-679)."""
        if opts.realspace_ccf_from_data:
            r_par_fid = r_par / _per_row(apar, r_par)
            r_perp_fid = s_perp / _per_row(aperp, s_perp)
            rr_fid = torch.sqrt(r_par_fid ** 2 + r_perp_fid ** 2)
            return xi_real(rr_fid, r_par_fid / rr_fid)
        return xi_real(r_eval, mu_r)

    # --- AP-corrected coordinates (ccf_model.py:641-644) ---
    # layout: batch, then velocity node (when there is a velocity integral),
    # then the flat (mu, s) point axis
    def b3(v):
        return v[:, None, None]

    s_perp = S * torch.sqrt(1.0 - Mu ** 2) * aperp[:, None]          # (B, q)
    s_par = S * Mu * apar[:, None]                                   # (B, q)

    if opts.rsd_model in ('kaiser', 'euclid_special'):
        return _kaiser_xi(opts, params, vr_at, vr_dvr_at, xi_at, s_par,
                          s_perp, iaH_true, resc)

    sigma_v = _param(params, 'sigma_v', 380.0)
    v_par = tables.x_nodes[None, :, None] * b3(sigma_v)              # (B, n_v, 1)
    jacobian = None
    if opts.rsd_model == 'streaming':
        # --- streaming model (ccf_model.py:649-657) ---
        r_par = s_par[:, None, :] - v_par * b3(iaH_true)             # (B, n_v, q)
        rr = torch.sqrt(s_perp[:, None, :] ** 2 + r_par ** 2)
        mu_r = r_par / rr
        # sigma_v, v_r and xi share one division while resc_vel is resc
        # (victor_tpu divides for each: the same values); under the
        # excursion-set model v_r takes its own
        r_eval = rr / b3(resc)
        if opts.streaming_eval == 'fast' and tables.sv_surf.y_const:
            # degree-48 Chebyshev compressions of v_r and of the
            # mu-independent sigma_v template (victor_tpu's throughput
            # mode; bounds in tests/test_golden.py::test_streaming_fast_bound)
            lo = tables.spline_vel.x[0] * resc_vel
            hi = tables.spline_vel.x[-1] * resc_vel
            coef_v = chebyshev_fit(vr_at, lo, hi, degree=48)
            slo = tables.sv_surf.x[0] * resc
            shi = tables.sv_surf.x[-1] * resc

            def sv_1d(q):
                return tables.sv_surf.ev(q / resc[:, None], torch.zeros_like(q))

            coef_s = chebyshev_fit(sv_1d, slo, shi, degree=48)
            # both series over rr in one pass (one kernel launch on the card)
            vr_rr, sv_rr = chebyshev_eval_multi(((coef_v, lo, hi),
                                                 (coef_s, slo, shi)), rr)
            mean = vr_rr * mu_r
            sv = b3(sigma_v) * sv_rr
        else:
            if opts.streaming_eval == 'fast':
                # only the 1D factor compresses well enough: say so rather
                # than run the exact path under the fast mode's name
                logging.getLogger('victor_tpu_torch.theory').warning(
                    "streaming_eval='fast' ignored: the sigma_v surface is "
                    'mu-dependent (anisotropic dispersion template); running '
                    'the exact evaluation')
            sv = b3(sigma_v) * tables.sv_surf.ev(r_eval, mu_r)
            r_vel = r_eval if resc_vel is resc else rr / b3(resc_vel)
            mean = tables.spline_vel.eval(c_vr, r_vel) * mu_r
        vel_pdf = torch.exp(-0.5 * ((v_par - mean) / sv) ** 2) / (SQRT2PI * sv)
    else:
        # --- dispersion model (ccf_model.py:658-671) ---
        r_par, rr, mu_r, jacobian = _dispersion_solve(
            tables, opts, c_vr, c_dvr, vr_at, vr_dvr_at, s_par, s_perp, v_par,
            iaH_true, resc_vel)
        r_eval = rr / b3(resc)
        sv = b3(sigma_v) * tables.sv_surf.ev(r_eval, mu_r)
        vel_pdf = torch.exp(-0.5 * (v_par / sv) ** 2) / (SQRT2PI * sv)

    xi_rmu = xi_at(r_par, r_eval, mu_r, s_perp[:, None, :])

    # velocity integral: old-scipy simps(even='avg') weights on the fixed
    # n_v-node grid, dv = sigma_v * dx (ccf_model.py:690)
    integrand = (1.0 + xi_rmu) * vel_pdf if jacobian is None \
        else (1.0 + xi_rmu) * jacobian * vel_pdf
    return sigma_v[:, None] * torch.einsum('bvq,v->bq', integrand,
                                           tables.vel_weights) - 1.0


def _kaiser_xi(opts: TheoryOptions, params, vr_at, vr_dvr_at, xi_at, s_par,
               s_perp, iaH_true, resc):
    """The kaiser and euclid_special models, with no velocity integral
    (victor/ccf_model.py:692-784): (B, q). M and Q are Hamaus et al.'s
    nuisance parameters (default 1); `kaiser_coord_shift` solves for the
    real-space coordinate in `niter` fixed-point steps, or keeps r_par =
    s_par (the deliberately incorrect variant kept for reproducing published
    results, ccf_model.py:704-707)."""
    M = _param(params, 'M', 1.0)[:, None]
    Q = _param(params, 'Q', 1.0)[:, None]
    iaH = iaH_true[:, None]
    s_true = torch.sqrt(s_par ** 2 + s_perp ** 2)
    if opts.kaiser_coord_shift:
        r_par = s_par / (1.0 + M * iaH * vr_at(s_true) / s_true)
        for _ in range(opts.niter):
            rr = torch.sqrt(s_perp ** 2 + r_par ** 2)
            r_par = s_par / (1.0 + M * iaH * vr_at(rr) / rr)
    else:
        r_par = s_par
    rr = torch.sqrt(s_perp ** 2 + r_par ** 2)
    mu_r = r_par / rr

    vr_rr, dvr_rr = vr_dvr_at(rr)
    if opts.rsd_model == 'kaiser':
        J = M * vr_rr * iaH / rr + \
            M * Q * mu_r ** 2 * iaH * (dvr_rr - vr_rr / rr)
    else:
        J = 3.0 * M * vr_rr * iaH / rr + \
            2.0 * M * Q * mu_r ** 2 * iaH * (dvr_rr - vr_rr / rr)
    xi_rmu = xi_at(r_par, rr / resc[:, None], mu_r, s_perp)
    if opts.rsd_model == 'kaiser' and not opts.kaiser_approximation:
        return (1.0 + M * xi_rmu) / (1.0 + J) - 1.0
    return M * xi_rmu - J


def _dispersion_solve(tables, opts: TheoryOptions, c_vr, c_dvr, vr_at,
                      vr_dvr_at, s_par, s_perp, v_par, iaH_true, resc_vel):
    """The dispersion model's fixed-point solve for the mean real-space
    coordinate, and its Jacobian (victor_tpu/models/ccf_theory.py:284-357):
    (r_par, rr, mu_r, jacobian), each (B, n_v, q).

    The interior Picard iterations run on the exact velocity spline or on a
    degree-24 Chebyshev compression of it (`dispersion_interior`); the final
    iteration and the Jacobian run exactly ('exact'), reuse the final
    update's v_r with a degree-48 Chebyshev dv_r ('fast'), or run as one
    kernel (`ops.dispersion_final`, 'fused'); the exact Jacobian takes v_r
    and dv_r from one two-channel lookup (`vr_dvr_at`). niter = 0 keeps the
    initial guess and skips the final update."""
    def b3(v):
        return v[:, None, None]

    def dvr_at(q):
        rv = _per_row(resc_vel, q)
        return tables.spline_vel.eval(c_dvr, q / rv) / rv

    x = tables.spline_vel.x
    lo, hi = x[0] * resc_vel, x[-1] * resc_vel
    iaH = b3(iaH_true)
    sp2 = s_perp[:, None, :] ** 2                                    # (B, 1, q)
    A = s_par[:, None, :] - v_par * iaH                              # (B, n_v, q)
    s_true = torch.sqrt(s_par ** 2 + s_perp ** 2)                    # (B, q)
    if opts.niter == 0 or opts.dispersion_interior == 'exact':
        vr_interior = vr_at
        n_final = min(opts.niter, 1)
    else:
        coef = chebyshev_fit(vr_at, lo, hi, degree=24)

        def vr_interior(q):
            return chebyshev_eval(coef, lo, hi, q)

        n_final = 1
    denom = 1.0 + iaH_true[:, None] * vr_interior(s_true) / s_true   # (B, q)
    r_par = A / denom[:, None, :]
    for _ in range(max(opts.niter - 1, 0)):
        rr = torch.sqrt(sp2 + r_par ** 2)
        r_par = A / (1.0 + iaH * vr_interior(rr) / rr)

    if n_final and opts.dispersion_final == 'fused':
        return dispersion_final(x, c_vr, c_dvr, r_par, A, s_perp, iaH_true,
                                resc_vel)
    if n_final:
        rr_prev = torch.sqrt(sp2 + r_par ** 2)
        vr_prev = vr_at(rr_prev)                          # exact final pass
        r_par = A / (1.0 + iaH * vr_prev / rr_prev)
    rr = torch.sqrt(sp2 + r_par ** 2)
    mu_r = r_par / rr
    if n_final and opts.dispersion_final == 'fast':
        # at the fixed point rr - rr_prev is of the order of the convergence
        # error, so v_r(rr_prev) stands in for v_r(rr); dv_r is compressed
        vr_rr = vr_prev
        coef_d = chebyshev_fit(dvr_at, lo, hi, degree=48)
        dvr_rr = chebyshev_eval(coef_d, lo, hi, rr)
    else:
        vr_rr, dvr_rr = vr_dvr_at(rr)
    jacobian = 1.0 / (1.0 + vr_rr * iaH / rr
                      + iaH * mu_r ** 2 * (dvr_rr - vr_rr / rr))
    return r_par, rr, mu_r, jacobian


def theory_multipoles_grid(tables, spec: TableSpec, opts: TheoryOptions, params,
                           s: Optional[torch.Tensor] = None):
    """Theory multipoles at the data s bins: (B, n_ell_s, n_s)
    (victor/ccf_model.py:791-827)."""
    xi_smu = theory_xi_grid(tables, spec, opts, params, s=s)
    return torch.matmul(tables.proj, xi_smu)


def theory_vector(tables, spec: TableSpec, opts: TheoryOptions, params,
                  s: Optional[torch.Tensor] = None):
    """Stacked theory multipole vectors (B, n_ell_s * n_s)
    (victor/ccf_model.py:829-860)."""
    mult = theory_multipoles_grid(tables, spec, opts, params, s=s)
    return mult.reshape(mult.shape[0], -1)
