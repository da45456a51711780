"""CCF theory: the real-space to redshift-space mapping, batched.

The port of `victor_tpu/models/ccf_theory.py` for the slice the BOSS main path
runs: the Gaussian streaming model (victor/ccf_model.py:649-657) evaluated
exactly, with the template matter model, the linear mean velocity (with or
without `empirical_corr`), an isotropic real-space input and both AP
template-rescaling modes. Every other option raises NotImplementedError
naming its ROADMAP item; none is approximated.

Parameters are a dict of (B,) tensors. With q = n_mu * n_s flattened (mu
leading) and n_v velocity nodes, the streaming intermediates are (B, n_v, q);
each of the three spline lookups per point (v_r, sigma_v, xi_0) is one call
of `ops.ppoly_eval`, which runs the CUDA kernel on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import RSD_MODELS, TableSpec, TheoryOptions
from ..errors import InputError
from ..ops.splines import pchip_eval

SQRT2PI = 2.5066282746310002


def _unported(what: str, item: str):
    return NotImplementedError(
        f'{what} is not ported to victor_tpu_torch yet (ROADMAP {item})')


def require_exact_perf_modes(opts: TheoryOptions) -> None:
    """Raise for a perf mode the port does not have yet. 'auto' is allowed:
    unresolved, it evaluates as exact (as in victor_tpu)."""
    if opts.streaming_eval == 'fast':
        raise _unported("streaming_eval='fast'", 'Queue 1 item 5')
    if opts.beta_covariance == 'factored':
        raise _unported("beta_covariance='factored'", 'Queue 1 item 5')
    if opts.dispersion_final == 'fused':
        raise _unported("dispersion_final='fused'", 'Queue 2 item 2')


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


def theory_xi_points(tables, spec: TableSpec, opts: TheoryOptions, params,
                     S: torch.Tensor, Mu: torch.Tensor):
    """Redshift-space xi at paired points (S, Mu), both flat (q,): (B, q)."""
    if opts.rsd_model not in RSD_MODELS:
        raise InputError(f'theory_xi: Unrecognised choice of model {opts.rsd_model}')
    if opts.rsd_model != 'streaming':
        raise _unported(f'rsd_model={opts.rsd_model!r}', 'Queue 1 item 6')
    if not opts.assume_isotropic:
        raise _unported('assume_isotropic=False', 'Queue 1 item 6')
    if opts.realspace_ccf_from_data:
        raise _unported('realspace_ccf_from_data=True', 'Queue 1 item 6')
    require_exact_perf_modes(opts)

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

    # --- table-dependent coefficients ---
    y_mult = real_multipoles(tables, spec, beta)          # (B, n_ell, n_r)
    c_xi0 = tables.spline_mult.coeffs(y_mult[:, 0])       # (B, n_r-1, 4)
    vr, _ = velocity_terms(tables, spec, opts, params)
    c_vr = tables.spline_vel.coeffs(vr)                   # (B, n_r, 4)

    # --- AP-corrected coordinates (ccf_model.py:641-644) ---
    # layout: batch, then velocity node, then the flat (mu, s) point axis
    def b3(v):
        return v[:, None, None]

    s_perp = S * torch.sqrt(1.0 - Mu ** 2) * aperp[:, None]          # (B, q)
    s_par = S * Mu * apar[:, None]                                   # (B, q)
    sigma_v = _param(params, 'sigma_v', 380.0)
    v_par = tables.x_nodes[None, :, None] * b3(sigma_v)              # (B, n_v, 1)

    # --- streaming model (ccf_model.py:649-657) ---
    r_par = s_par[:, None, :] - v_par * b3(iaH_true)                 # (B, n_v, q)
    rr = torch.sqrt(s_perp[:, None, :] ** 2 + r_par ** 2)
    mu_r = r_par / rr
    # every template is rescaled by the same factor, so one division serves
    # the three lookups (victor_tpu divides for each: the same values)
    r_eval = rr / b3(resc)
    sv = b3(sigma_v) * tables.sv_surf.ev(r_eval, mu_r)
    mean = tables.spline_vel.eval(c_vr, r_eval) * mu_r
    vel_pdf = torch.exp(-0.5 * ((v_par - mean) / sv) ** 2) / (SQRT2PI * sv)
    xi_rmu = tables.spline_mult.eval(c_xi0, r_eval)

    # velocity integral: old-scipy simps(even='avg') weights on the fixed
    # n_v-node grid, dv = sigma_v * dx (ccf_model.py:690)
    integrand = (1.0 + xi_rmu) * vel_pdf
    return sigma_v[:, None] * torch.einsum('bvq,v->bq', integrand,
                                           tables.vel_weights) - 1.0


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
