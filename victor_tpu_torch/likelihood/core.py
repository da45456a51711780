"""Likelihood evaluation: chi-squared and the four likelihood forms, batched.

The port of `victor_tpu/likelihood/core.py` in both beta-covariance modes:
'exact' (dense blended covariance and slogdet) and 'factored' (per-grid
quadratic forms and the build-time pencil log-det, an exact refactoring).
Functional parity with CCFFit (victor/ccf_fit.py:166-483):
  * PCHIP interpolation of the data vector over the reconstruction beta grid,
  * the reference's covariance interpolation over beta, boundary clamping,
    exact-grid-point shortcut and the (1-t) C[low] + t C[END] endpoint blend
    that its `[0][-1]` index produces (ccf_fit.py:225-228,256-260), which the
    notebook goldens depend on,
  * the Gaussian / Hartlap / Sellentin / Percival forms (:415-473),
  * the log-det normalisation of a beta-varying covariance (:398-413),
  * both 'datavector' and 'likelihood' beta interpolation (:383-440),
  * singular-covariance and NaN guards returning (-inf, +inf).

Every function takes parameters as a dict of (B,) tensors and returns (B,)
results. `torch.where` evaluates both branches, as `jnp.where` does, so the
0/0 guards of the JAX package are kept as they are.
"""

from __future__ import annotations

import torch

from ..config import FitOptions, TableSpec, TheoryOptions
from ..errors import InputError
from ..models.ccf_theory import pchip_eval, theory_vector


def multipole_datavector(tables, spec: TableSpec, beta):
    """Stacked redshift-space data vectors (B, D) (victor/ccf_fit.py:306-323)."""
    if spec.fixed_data:
        return tables.data_mult_fixed.reshape(1, -1).expand(beta.shape[0], -1)
    dv = pchip_eval(tables.beta_ccf, tables.data_mult_pchip_c, beta)
    return dv.reshape(beta.shape[0], -1)


def _grid_blend(grid, beta):
    """Where beta (B,) falls on the grid, as the reference's covariance
    interpolation reads it (victor/ccf_fit.py:195-260): (low, kk, is_exact,
    t). kk is the first index with grid >= beta (clamped), low the one
    before it, and t the weight of the *last* grid point, which reproduces
    `[0][-1]` at ccf_fit.py:226,258."""
    n = grid.shape[0]
    k = torch.searchsorted(grid, beta, right=False)   # first index with grid >= beta
    low = torch.clamp(k - 1, 0, n - 1)
    kk = torch.clamp(k, 0, n - 1)
    is_exact = grid[kk] == beta
    denom = grid[n - 1] - grid[low]
    t = (beta - grid[low]) / torch.where(denom == 0, 1.0, denom)
    return low, kk, is_exact, t


def _interp_matrix_stack(grid, stack, beta):
    """The reference's covariance interpolation over the beta grid
    (victor/ccf_fit.py:195-260): stack (n, D, D), beta (B,) -> (B, D, D).

    Clamp outside the grid to the boundary matrix; return the grid matrix
    exactly at grid points; otherwise blend (1-t) * stack[low] +
    t * stack[-1] (`_grid_blend`)."""
    n = grid.shape[0]
    low, kk, is_exact, t = _grid_blend(grid, beta)
    t = t[:, None, None]
    out = (1.0 - t) * stack[low] + t * stack[n - 1]
    out = torch.where(is_exact[:, None, None], stack[kk], out)
    out = torch.where((beta < grid[0])[:, None, None], stack[0], out)
    out = torch.where((beta > grid[-1])[:, None, None], stack[-1], out)
    return out


def _interp_rows(grid, rows, beta):
    """`_interp_matrix_stack` on one stack of scalars per batch row: rows
    (B, n), beta (B,) -> (B,), row b interpolated at beta[b]."""
    n = grid.shape[0]
    low, kk, is_exact, t = _grid_blend(grid, beta)

    def pick(idx):
        return rows.gather(1, idx[:, None])[:, 0]

    out = (1.0 - t) * pick(low) + t * rows[:, n - 1]
    out = torch.where(is_exact, pick(kk), out)
    out = torch.where(beta < grid[0], rows[:, 0], out)
    out = torch.where(beta > grid[-1], rows[:, -1], out)
    return out


def _use_factored(tables, spec: TableSpec, opts: TheoryOptions) -> bool:
    """Whether the 'factored' beta-covariance path applies: the resolved
    mode (an unresolved 'auto' evaluates exact), a beta-varying covariance,
    and a pencil factorization (the build leaves None for a stack that is
    not positive definite)."""
    return (opts.beta_covariance == 'factored' and not spec.fixed_covmat
            and tables.cov_logdet is not None)


def _factored_chi_squared(grid, icov_stack, diff, beta):
    """diff^T interp(C^-1) diff without the blended matrix: each row's
    residual against every grid precision, then the reference's
    interpolation of those (B, n_b) quadratic forms. Identical in exact
    arithmetic, since the interpolation is linear in the matrix."""
    tmp = torch.einsum('nij,bj->bni', icov_stack, diff)
    q = torch.einsum('bni,bi->bn', tmp, diff)
    return _interp_rows(grid, q, beta)


def _pencil_like_factor(grid, logdets, lam, beta):
    """-0.5 log det of the blended covariance from the build-time pencil
    factorization (io/tables.py:_pencil_precompute), O(D) per row in place
    of a dense slogdet, with `_interp_matrix_stack`'s clamp, exact-grid and
    endpoint-blend semantics. Returns (factor, ok) like `_like_factor`; the
    blend is positive definite iff every (1-t) + t * lam_i > 0."""
    n = grid.shape[0]
    low, kk, at_grid, t = _grid_blend(grid, beta)
    s = (1.0 - t)[:, None] + t[:, None] * lam[low]                  # (B, D)
    pos = s > 0
    ld = logdets[low] + torch.sum(torch.log(torch.where(pos, s, 1.0)), dim=-1)
    # exact grid points and clamps take the grid log-det (every grid slice
    # is positive definite, or the build gave no factorization)
    below, above = beta < grid[0], beta > grid[-1]
    override = at_grid | below | above
    ld_override = torch.where(at_grid, logdets[kk],
                              torch.where(below, logdets[0], logdets[n - 1]))
    ld = torch.where(override, ld_override, ld)
    ok = override | torch.all(pos, dim=-1)
    return -0.5 * ld, ok


def interpolated_covariance(tables, spec: TableSpec, beta):
    if spec.fixed_covmat:
        return tables.cov.expand(beta.shape[0], -1, -1)
    return _interp_matrix_stack(tables.beta_cov, tables.cov, beta)


def interpolated_precision(tables, spec: TableSpec, beta):
    if spec.fixed_covmat:
        return tables.icov.expand(beta.shape[0], -1, -1)
    return _interp_matrix_stack(tables.beta_cov, tables.icov, beta)


def chi_squared(tables, spec: TableSpec, opts: TheoryOptions, params):
    """(theory - data)^T C^-1 (theory - data), and the covariance used, each
    per batch row (victor/ccf_fit.py:325-354). The covariance is None on the
    factored path, which never forms it."""
    if tables.cov is None:
        raise InputError('data block has no covariance_matrix: a '
                         'single-dataset likelihood needs one')
    if 'beta' not in params and not (spec.fixed_data and spec.fixed_covmat):
        raise InputError('Need to supply a value of beta to interpolate the '
                         'beta-dependent data vector / covariance')
    tv = theory_vector(tables, spec, opts, params)
    beta = params['beta'] if 'beta' in params else torch.zeros_like(tv[:, 0])
    diff = tv - multipole_datavector(tables, spec, beta)
    if _use_factored(tables, spec, opts):
        # no blended covariance: log_likelihood takes the pencil log-det
        return _factored_chi_squared(tables.beta_cov, tables.icov, diff,
                                     beta), None
    cov = interpolated_covariance(tables, spec, beta)
    icov = interpolated_precision(tables, spec, beta)
    chisq = torch.einsum('bi,bij,bj->b', diff, icov, diff)
    return chisq, cov


def _like_factor(cov):
    """-0.5 log det C per batch row, with a singular-covariance guard:
    returns (factor, ok)."""
    sign, logdet = torch.linalg.slogdet(cov)
    return -0.5 * logdet, sign == 1


def _cov_like_factor(tables, cov, beta):
    """The dense slogdet when chi_squared formed the blended covariance, the
    pencil log-det when the factored path did not (cov is None)."""
    if cov is None:
        return _pencil_like_factor(tables.beta_cov, tables.cov_logdet,
                                   tables.cov_pencil, beta)
    return _like_factor(cov)


def _apply_form(chisq, like_factor, fit: FitOptions, ndata: int):
    """The four likelihood forms (victor/ccf_fit.py:415-437,455-473)."""
    form = fit.form.lower()
    if form == 'sellentin':
        nmocks = fit.nmocks
        return -nmocks * torch.log(1.0 + chisq / (nmocks - 1)) / 2.0 + like_factor
    if form == 'hartlap':
        nmocks = fit.nmocks
        a = (nmocks - ndata - 2) / (nmocks - 1)
        return -0.5 * chisq * a + like_factor
    if form == 'percival':
        nmocks = fit.nmocks
        if fit.nparams is None:
            raise InputError("likelihood form 'percival' requires nparams")
        nparams = fit.nparams
        B = (nmocks - ndata - 2) / ((nmocks - ndata - 1) * (nmocks - ndata - 4))
        m = nparams + 2 + (nmocks - 1 + B * (ndata - nparams)) / (1 + B * (ndata - nparams))
        return -m * torch.log(1.0 + chisq / (nmocks - 1)) / 2.0 + like_factor
    if form == 'gaussian':
        return -0.5 * chisq + like_factor
    raise InputError('Unrecognised likelihood form')


def log_likelihood(tables, spec: TableSpec, opts: TheoryOptions,
                   fit: FitOptions, params):
    """(lnlike, chisq), each (B,) (victor/ccf_fit.py:356-483)."""
    ndata = spec.n_s * len(spec.poles_s)

    if fit.beta_interpolation == 'likelihood' and not spec.fixed_data:
        # bracket beta on the data grid, evaluate chi^2 at both grid points
        # and interpolate the log-likelihoods linearly (ccf_fit.py:383-440)
        beta = params['beta']
        grid = tables.beta_ccf
        n = grid.shape[0]
        k = torch.searchsorted(grid, beta, right=False)   # first >= beta
        low = torch.clamp(k - 1, 0, n - 1)
        high = torch.clamp(k, 0, n - 1)
        # double-where: low == high whenever beta <= grid[0] or beta >
        # grid[-1]; the guard keeps beta == grid[0] valid (t = 0)
        denom = grid[high] - grid[low]
        t = (beta - grid[low]) / torch.where(denom == 0, 1.0, denom)
        p_low = dict(params)
        p_low['beta'] = grid[low]
        p_high = dict(params)
        p_high['beta'] = grid[high]
        chisq_low, cov_low = chi_squared(tables, spec, opts, p_low)
        chisq_high, cov_high = chi_squared(tables, spec, opts, p_high)

        if not spec.fixed_covmat:
            lf_low, ok_low = _cov_like_factor(tables, cov_low, grid[low])
            lf_high, ok_high = _cov_like_factor(tables, cov_high, grid[high])
            ok = ok_low & ok_high
        else:
            lf_low = lf_high = torch.zeros_like(beta)
            ok = torch.ones_like(beta, dtype=torch.bool)

        ln_low = _apply_form(chisq_low, lf_low, fit, ndata)
        ln_high = _apply_form(chisq_high, lf_high, fit, ndata)
        lnlike = (1.0 - t) * ln_low + t * ln_high
        chisq = (1.0 - t) * chisq_low + t * chisq_high
        # beta outside the data grid: the reference raises IndexError
        # (ccf_fit.py:389-390); the batch-safe intent is the (-inf, +inf)
        # sentinel (PARITY.md)
        out_of_grid = (beta < grid[0]) | (beta > grid[-1])
        lnlike = torch.where(out_of_grid, -torch.inf, lnlike)
        chisq = torch.where(out_of_grid, torch.inf, chisq)
    else:
        chisq, cov = chi_squared(tables, spec, opts, params)
        if not spec.fixed_covmat:
            lf, ok = _cov_like_factor(tables, cov, params['beta'])
        else:
            lf = torch.zeros_like(chisq)
            ok = torch.ones_like(chisq, dtype=torch.bool)
        lnlike = _apply_form(chisq, lf, fit, ndata)

    # guards: singular covariance or NaN -> (-inf, +inf) (ccf_fit.py:400-410,477-481)
    bad = ~ok | torch.isnan(lnlike)
    lnlike = torch.where(bad, -torch.inf, lnlike)
    chisq = torch.where(bad, torch.inf, chisq)
    return lnlike, chisq
