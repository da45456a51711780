"""Composed linear operators that fold whole reference code paths into matrices.

Each builder *probes* the exact reference numerical recipe (scipy splines +
trapz on fixed grids) with unit basis vectors on the host, so the device-side
computation - a single matmul - reproduces the reference bit-for-bit at
float64. All of these are init-time only.
"""

from __future__ import annotations

import numpy as np

from .integrate import trapz_weights
from .legendre import legendre_p
from .splines import spline_eval_matrix, gradient_matrix


def multipole_projection_matrix(mu_grid: np.ndarray, ells, npts: int = 200,
                                even: bool = True) -> np.ndarray:
    """P of shape (len(ells), len(mu_grid)) with P @ xi_col == multipoles.

    Folds the reference projection pipeline - bicubic interp2d of xi(s, mu) on
    the theory mu grid, resampled to an `npts`-point mu grid, multiplied by
    P_ell and trapz-integrated (victor/ccf_model.py:823-825 + utils.py:46-57) -
    into one matrix. The reduction is exact because the tensor-product
    interpolating spline restricted to a data node s_j is the unique univariate
    interpolating cubic through that column.
    """
    mu_grid = np.asarray(mu_grid, dtype=np.float64)
    if even:
        mu_fine = np.linspace(0.0, 1.0, npts)
        factors = {ell: 2 * ell + 1 for ell in ells}
    else:
        mu_fine = np.linspace(-1.0, 1.0, npts)
        factors = {ell: (2 * ell + 1) / 2 for ell in ells}
    E = spline_eval_matrix(mu_grid, mu_fine, ext=0)      # (npts, n_mu)
    tw = trapz_weights(mu_fine)                          # (npts,)
    P = np.zeros((len(ells), len(mu_grid)))
    for i, ell in enumerate(ells):
        P[i] = factors[ell] * ((tw * legendre_p(ell, mu_fine)) @ E)
    return P


def enclosed_density_operator(r_knots: np.ndarray, r_out: np.ndarray,
                              n_quad: int = 100) -> np.ndarray:
    """M with (M @ y) == 3/r_out^3 * integral_0^r_out spline(r_knots, y)(x) x^2 dx.

    Reproduces the linear-bias enclosed-density integral at
    victor/ccf_model.py:363-369 (spline with ext=3, per-point 100-node trapz).
    The 1/bias factor is applied by the caller.
    """
    from scipy.interpolate import InterpolatedUnivariateSpline
    r_knots = np.asarray(r_knots, dtype=np.float64)
    r_out = np.asarray(r_out, dtype=np.float64)
    n = len(r_knots)
    M = np.zeros((len(r_out), n))
    for j in range(n):
        e = np.zeros(n)
        e[j] = 1.0
        spl = InterpolatedUnivariateSpline(r_knots, e, k=3, ext=3)
        for i, ri in enumerate(r_out):
            rarr = np.linspace(0.0, ri, n_quad)
            M[i, j] = 3.0 * np.trapezoid(spl(rarr) * rarr ** 2, rarr) / ri ** 3
    return M


def resampled_gradient_operator(x_fine: np.ndarray, x_out: np.ndarray) -> np.ndarray:
    """D with (D @ y_fine) == spline(x_fine, np.gradient(y_fine, x_fine), ext=3)(x_out).

    The reference repeatedly estimates derivatives by `np.gradient` on a finer
    grid followed by an ext=3 spline resample (victor/ccf_model.py:455-459,
    469-473, 487-490); this folds both steps into one matrix.
    """
    E = spline_eval_matrix(x_fine, x_out, ext=3)
    G = gradient_matrix(x_fine)
    return E @ G
