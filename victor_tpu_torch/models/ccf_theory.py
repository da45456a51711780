"""CCF theory: the real-space to redshift-space mapping, batched.

The port of `victor_tpu/models/ccf_theory.py` for the Gaussian streaming
model (victor/ccf_model.py:649-657) and the dispersion model (:658-671),
with the template matter model, the linear mean velocity (with or without
`empirical_corr`), an isotropic real-space input and both AP
template-rescaling modes, in every perf mode of those two models:
`streaming_eval` 'exact' and 'fast', `dispersion_interior` 'exact' and
'chebyshev', `dispersion_final` 'exact', 'fast' and 'fused'. Every other
option raises NotImplementedError naming its ROADMAP item; none is
approximated.

Parameters are a dict of (B,) tensors. With q = n_mu * n_s flattened (mu
leading) and n_v velocity nodes, the intermediates are (B, n_v, q). Each
exact spline lookup (v_r, sigma_v, xi_0) is one call of `ops.ppoly_eval`,
and the fused dispersion final stage one call of `ops.dispersion_final`;
both run CUDA kernels on the card.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch

from ..config import RSD_MODELS, TableSpec, TheoryOptions
from ..errors import InputError
from ..ops.splines import (chebyshev_eval, chebyshev_fit, dispersion_final,
                           pchip_eval)

SQRT2PI = 2.5066282746310002


def _unported(what: str, item: str):
    return NotImplementedError(
        f'{what} is not ported to victor_tpu_torch yet (ROADMAP {item})')


def _param(params, key, default):
    """params[key], or `default` broadcast to the batch shape."""
    if key in params:
        return params[key]
    like = next(iter(params.values()))
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
    delta_100, Delta_100), shared by the whole batch."""
    if opts.matter_model == 'template':
        return (tables.delta_rv, tables.Delta_rv,
                tables.delta_r100, tables.Delta_r100)
    if opts.matter_model == 'linear_bias':
        raise _unported("matter_model='linear_bias'", 'Queue 1 item 6')
    if opts.matter_model == 'excursion_set':
        raise _unported("matter_model='excursion_set'", 'Queue 1 item 7')
    raise InputError(f'Invalid choice of matter_model {opts.matter_model}')


def velocity_terms(tables, spec: TableSpec, opts: TheoryOptions, params):
    """Mean radial velocity v_r and dv_r/dr at the r_v nodes, each (B, n_rv)
    (victor/ccf_model.py:385-492), multiplied by the true 1/(aH)."""
    _, _, apar = resolve_ap(params)
    iaH_true = (tables.iaH * apar)[:, None]
    delta_rv, Delta_rv, delta_100, Delta_100 = delta_profiles(tables, spec,
                                                              opts, params)
    if opts.mean_model != 'linear':
        if opts.mean_model not in ('template', 'nonlinear'):
            raise InputError(f'Invalid choice of mean_model {opts.mean_model}')
        raise _unported(f'mean_model={opts.mean_model!r}', 'Queue 1 item 6')
    growth_term = (params['fsigma8'] / tables.template_sigma8)[:, None]

    r_v, r100 = tables.r_v, tables.rgrid100
    if not opts.empirical_corr:
        vr = -growth_term * r_v * Delta_rv / (3.0 * iaH_true)
        dvr = -growth_term * (delta_rv - 2.0 * Delta_rv / 3.0) / iaH_true
    else:
        Av = _param(params, 'Av', 0.0)[:, None]
        vr = -growth_term * r_v * Delta_rv * (1.0 + Av * delta_rv) / (3.0 * iaH_true)
        vr100 = -growth_term * r100 * Delta_100 * (1.0 + Av * delta_100) / (3.0 * iaH_true)
        dvr = vr100 @ tables.dvr_op.T
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
    if opts.rsd_model not in ('streaming', 'dispersion'):
        raise _unported(f'rsd_model={opts.rsd_model!r}', 'Queue 1 item 6')
    if not opts.assume_isotropic:
        raise _unported('assume_isotropic=False', 'Queue 1 item 6')
    if opts.realspace_ccf_from_data:
        raise _unported('realspace_ccf_from_data=True', 'Queue 1 item 6')

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
    # templates are not rescaled (ccf_model.py:626-632); that matter model
    # raises in velocity_terms until it is ported
    resc_vel = torch.ones_like(resc) if opts.matter_model == 'excursion_set' \
        else resc

    # --- table-dependent coefficients ---
    y_mult = real_multipoles(tables, spec, beta)          # (B, n_ell, n_r)
    c_xi0 = tables.spline_mult.coeffs(y_mult[:, 0])       # (B, n_r-1, 4)
    vr, dvr = velocity_terms(tables, spec, opts, params)
    c_vr = tables.spline_vel.coeffs(vr)                   # (B, n_rv-1, 4)

    def vr_at(q):
        return tables.spline_vel.eval(c_vr, q / _per_row(resc_vel, q))

    # --- AP-corrected coordinates (ccf_model.py:641-644) ---
    # layout: batch, then velocity node, then the flat (mu, s) point axis
    def b3(v):
        return v[:, None, None]

    s_perp = S * torch.sqrt(1.0 - Mu ** 2) * aperp[:, None]          # (B, q)
    s_par = S * Mu * apar[:, None]                                   # (B, q)
    sigma_v = _param(params, 'sigma_v', 380.0)
    v_par = tables.x_nodes[None, :, None] * b3(sigma_v)              # (B, n_v, 1)

    jacobian = None
    if opts.rsd_model == 'streaming':
        # --- streaming model (ccf_model.py:649-657) ---
        r_par = s_par[:, None, :] - v_par * b3(iaH_true)             # (B, n_v, q)
        rr = torch.sqrt(s_perp[:, None, :] ** 2 + r_par ** 2)
        mu_r = r_par / rr
        # sigma_v and xi_0 share one division (victor_tpu divides for each:
        # the same values)
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
            mean = chebyshev_eval(coef_v, lo, hi, rr) * mu_r
            sv = b3(sigma_v) * chebyshev_eval(coef_s, slo, shi, rr)
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
        c_dvr = tables.spline_vel.coeffs(dvr)             # (B, n_rv-1, 4)
        r_par, rr, mu_r, jacobian = _dispersion_solve(
            tables, opts, c_vr, c_dvr, vr_at, s_par, s_perp, v_par, iaH_true,
            resc_vel)
        r_eval = rr / b3(resc)
        sv = b3(sigma_v) * tables.sv_surf.ev(r_eval, mu_r)
        vel_pdf = torch.exp(-0.5 * (v_par / sv) ** 2) / (SQRT2PI * sv)

    xi_rmu = tables.spline_mult.eval(c_xi0, r_eval)

    # velocity integral: old-scipy simps(even='avg') weights on the fixed
    # n_v-node grid, dv = sigma_v * dx (ccf_model.py:690)
    integrand = (1.0 + xi_rmu) * vel_pdf if jacobian is None \
        else (1.0 + xi_rmu) * jacobian * vel_pdf
    return sigma_v[:, None] * torch.einsum('bvq,v->bq', integrand,
                                           tables.vel_weights) - 1.0


def _dispersion_solve(tables, opts: TheoryOptions, c_vr, c_dvr, vr_at, s_par,
                      s_perp, v_par, iaH_true, resc_vel):
    """The dispersion model's fixed-point solve for the mean real-space
    coordinate, and its Jacobian (victor_tpu/models/ccf_theory.py:284-357):
    (r_par, rr, mu_r, jacobian), each (B, n_v, q).

    The interior Picard iterations run on the exact velocity spline or on a
    degree-24 Chebyshev compression of it (`dispersion_interior`); the final
    iteration and the Jacobian run exactly ('exact'), reuse the final
    update's v_r with a degree-48 Chebyshev dv_r ('fast'), or run as one
    kernel (`ops.dispersion_final`, 'fused'). niter = 0 keeps the initial
    guess and skips the final update."""
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
        vr_rr = vr_at(rr)
        dvr_rr = dvr_at(rr)
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
