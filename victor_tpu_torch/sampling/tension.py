"""Dataset concordance / tension statistics between two CCF datasets.

The port of `victor_tpu/sampling/tension.py`. Reference users quantify
agreement between datasets (e.g. two redshift bins, two void catalogues,
data vs mocks) by eye on GetDist contours; here the two standard
quantitative statistics run on the card in one command
(`python -m victor_tpu_torch tension cfgA.yaml cfgB.yaml`):

1. **Evidence ratio** (Marshall, Rajguru & Slosar 2006, astro-ph/0412535):

       ln R = ln Z_AB - ln Z_A - ln Z_B

   where Z_AB is the evidence of the INDEPENDENT product likelihood
   lnL_A + lnL_B at shared parameters (targets.ProductTarget) and all
   three evidences use the SAME prior (the shared params block). ln R > 0
   favours "one parameter vector describes both datasets" (concordance);
   ln R < 0 favours separate parameter vectors (tension). Like every
   evidence ratio it is prior-volume dependent — quote the prior with it.
   Each Z comes from tempered SMC (sampling/smc.py) with its
   correlation-inflated error bar; the three errors add in quadrature.

2. **Gaussian parameter shift**: with posterior means m_A, m_B and
   covariances C_A, C_B estimated from the SMC particle clouds of the
   separate fits (valid when both posteriors are near-Gaussian — inspect
   the corner plots when in doubt),

       chi2_shift = (m_A - m_B)^T (C_A + C_B)^{-1} (m_A - m_B)

   is chi2-distributed with rank(C_A + C_B) dof under concordance (the
   Raveri & Hu 2019 "parameter difference" statistic in its Gaussian
   limit); reported as a tail probability and the equivalent two-sided
   n-sigma.

The two statistics are complementary: ln R integrates over the full
posterior mass (sensitive to volume effects), the parameter shift is
prior-independent but Gaussian-approximate.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
from scipy import stats

from ..utils.logging import get_logger
from .targets import ProductTarget

log = get_logger('tension')


@dataclasses.dataclass
class TensionResult:
    logr: float                  # ln Z_AB - ln Z_A - ln Z_B
    logr_se: float               # quadrature sum of the three SMC se's
    logz_a: float
    logz_b: float
    logz_ab: float
    shift_chi2: float            # Gaussian parameter-shift statistic
    shift_ndof: int
    shift_p: float               # chi2 tail probability
    shift_nsigma: float          # two-sided Gaussian equivalent
    names: list                  # shared sampled parameter names
    summary_a: Dict[str, Dict[str, float]]
    summary_b: Dict[str, Dict[str, float]]
    summary_ab: Dict[str, Dict[str, float]]
    elapsed_s: float


def parameter_shift(mean_a, cov_a, mean_b, cov_b):
    """(chi2, ndof, p, nsigma) of the Gaussian parameter-difference test.

    `ndof` is the RANK of C_A + C_B, not the raw dimension: pinv zeroes
    rank-deficient directions out of chi2, so counting them as dof would
    bias p high and under-report a real tension."""
    d = np.atleast_1d(np.asarray(mean_a, dtype=np.float64)
                      - np.asarray(mean_b, dtype=np.float64))
    # atleast_2d: np.cov of a single-parameter cloud is 0-d
    c = np.atleast_2d(np.asarray(cov_a, dtype=np.float64)
                      + np.asarray(cov_b, dtype=np.float64))
    # pinv guards near-degenerate directions (prior-pinned parameters have
    # matching clouds in both fits, contributing ~0 to the shift)
    chi2 = float(d @ np.linalg.pinv(c) @ d)
    ndof = int(np.linalg.matrix_rank(c))
    p = float(stats.chi2.sf(chi2, ndof))
    # two-sided Gaussian equivalent; isf keeps precision where sf(p/2)
    # underflows
    nsigma = float(stats.norm.isf(p / 2.0)) if p > 0 else float('inf')
    return chi2, ndof, p, nsigma


def run_tension(bundle_a, bundle_b, params_block: Dict,
                n_particles: int = 4096, n_moves: int = 8, seed: int = 0,
                opts_kw: Optional[Dict] = None, fit_kw: Optional[Dict] = None,
                chunk: Optional[int] = 64, mesh=None, mesh_axis=None,
                device='cuda') -> TensionResult:
    """Three tempered-SMC runs (A, B, product AB at shared params) -> the
    evidence ratio ln R and the Gaussian parameter-shift n-sigma.

    `bundle_a`/`bundle_b` are any run_smc target kind, on `device` (the
    card unless 'cpu' is asked for; `mesh` shards each run's likelihood as
    run_smc does); `params_block` is the SHARED
    cobaya-style block (identical prior for all three runs — the ratio is
    meaningless otherwise). Distinct seeds per run keep the three evidence
    errors independent so they add in quadrature.
    """
    from .smc import run_smc

    t0 = time.time()
    kw = dict(n_particles=n_particles, n_moves=n_moves, chunk=chunk,
              opts_kw=opts_kw, fit_kw=fit_kw, mesh=mesh, mesh_axis=mesh_axis,
              device=device)
    res_a = run_smc(bundle_a, params_block, seed=seed, **kw)
    res_b = run_smc(bundle_b, params_block, seed=seed + 1, **kw)
    res_ab = run_smc(ProductTarget((bundle_a, bundle_b)), params_block,
                     seed=seed + 2, **kw)

    logr = res_ab.logz - res_a.logz - res_b.logz
    logr_se = float(np.sqrt(res_a.logz_se ** 2 + res_b.logz_se ** 2
                            + res_ab.logz_se ** 2))

    names = [p.name for p in res_a.space.sampled]
    pa, pb = res_a.particles, res_b.particles
    chi2, ndof, p, nsigma = parameter_shift(
        pa.mean(axis=0), np.cov(pa, rowvar=False),
        pb.mean(axis=0), np.cov(pb, rowvar=False))

    out = TensionResult(
        logr=float(logr), logr_se=logr_se, logz_a=res_a.logz,
        logz_b=res_b.logz, logz_ab=res_ab.logz, shift_chi2=chi2,
        shift_ndof=ndof, shift_p=p, shift_nsigma=nsigma, names=names,
        summary_a=res_a.summary(), summary_b=res_b.summary(),
        summary_ab=res_ab.summary(), elapsed_s=time.time() - t0)
    log.info('tension: ln R = %.3f +/- %.3f (%s), parameter shift %.2f '
             'sigma (chi2 %.2f / %d dof, p = %.4f)', out.logr, out.logr_se,
             'concordance' if out.logr > 0 else 'tension',
             out.shift_nsigma, out.shift_chi2, out.shift_ndof, out.shift_p)
    return out
