"""Goodness-of-fit statistics for the CCF likelihood.

The port of `victor_tpu/sampling/gof.py`, host-side numpy and scipy as
there (the port keeps its own copy: it imports nothing of victor_tpu).

The reference package offers no model-adequacy machinery (its notebooks
eyeball chi2 against the data-vector length); this module adds the two
standard measures, both consistent with the configured likelihood form:

* `chi2_tail_probability` — frequentist PTE of an observed chi-squared
  statistic. Exact chi2(ndof) tail for the `gaussian` form; for the
  estimated-covariance forms (`sellentin` / `hartlap` / `percival`,
  covariance built from `nmocks` simulations) the null distribution of
  T = r' Chat^{-1} r is not chi2(n) but Hotelling's T^2 with nu = m-1
  degrees of freedom: (m-n)/(n(m-1)) T ~ F(n, m-n). The plain chi2 tail is
  systematically optimistic, and not negligibly so in the tail even at the
  BOSS configuration (ndof=56, m=1000: p 0.099 -> 0.175 at chi2=70).

* `posterior_predictive_pvalue` — Bayesian model adequacy (Gelman, Meng &
  Stern 1996): p = Pr(T(y_rep, theta) >= T(y_obs, theta) | y_obs) with the
  discrepancy T(y, theta) = r' C^{-1} r and (theta, y_rep) drawn from the
  posterior and the likelihood. Because T(y_rep, theta) | theta is
  parameter-INDEPENDENT (chi2(ndata) under Gaussian generation, the
  Hotelling F above under estimated covariance), the replicated-data Monte
  Carlo is analytic: average the per-draw tail probability of the observed
  statistic over posterior draws. Feed it the chi2 column that SMC / the
  chains already record per draw ('chi2_ccf_correct') — zero extra device
  work.

Host-side (scipy.stats) on tiny arrays.
"""

from __future__ import annotations

import numpy as np

__all__ = ['chi2_tail_probability', 'posterior_predictive_pvalue']

_ESTIMATED_COV_FORMS = ('sellentin', 'hartlap', 'percival')


def chi2_tail_probability(chi2, ndof: int, form: str = 'gaussian',
                          nmocks: int | None = None):
    """Tail probability (PTE) of the observed statistic under the fitted
    likelihood form. `chi2` may be a scalar or array; returns the same shape
    (floats). Requires nmocks > ndof + 1 for the Hotelling correction to
    exist; otherwise (or for form='gaussian') the chi2(ndof) tail is used.
    """
    from scipy import stats
    c = np.asarray(chi2, dtype=np.float64)
    # lowercase like likelihood/core does at ITS point of use — a
    # capitalized 'Sellentin' must not silently fall back to the
    # optimistic chi2 tail this module exists to correct
    form = (form or '').lower()
    if form in _ESTIMATED_COV_FORMS and nmocks and nmocks > ndof + 1:
        m = float(nmocks)
        scale = (m - ndof) / (ndof * (m - 1.0))
        out = stats.f.sf(scale * c, ndof, m - ndof)
    else:
        out = stats.chi2.sf(c, ndof)
    return float(out) if np.ndim(chi2) == 0 else out


def posterior_predictive_pvalue(chi2_draws, ndata: int,
                                form: str = 'gaussian',
                                nmocks: int | None = None) -> float:
    """Posterior-predictive p-value from per-draw observed chi2 statistics.

    `chi2_draws`: (N,) chi2 of the OBSERVED data at N posterior draws (e.g.
    `SMCResult.aux[:, 0]` or a chain's chi2 column). `ndata`: data-vector
    length (the discrepancy conditions on theta, so the reference
    distribution has the FULL data dimension — no parameter-count
    subtraction). Values near 0 mean the model cannot reproduce the data;
    values near 1 mean overdispersion (e.g. an overestimated covariance);
    calibrated-but-conservative by construction (Gelman et al. 1996).
    """
    tails = chi2_tail_probability(np.asarray(chi2_draws, dtype=np.float64),
                                  ndata, form, nmocks)
    return float(np.mean(tails))
