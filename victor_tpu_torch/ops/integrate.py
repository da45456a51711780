"""Fixed-node quadrature weights.

The reference integrates with scipy's (pre-1.14) `simps` default even='avg'
(victor/ccf_model.py:690) and `np.trapz` on fixed grids; both are linear in the
integrand, so on device they are a single weighted reduction with precomputed
weights.
"""

from __future__ import annotations

import numpy as np


def trapz_weights(x: np.ndarray) -> np.ndarray:
    """Weights w such that w @ y == np.trapz(y, x)."""
    x = np.asarray(x, dtype=np.float64)
    w = np.zeros_like(x)
    d = np.diff(x)
    w[:-1] += d / 2.0
    w[1:] += d / 2.0
    return w


def simpson_weights(n: int, dx: float = 1.0) -> np.ndarray:
    """Weights for composite Simpson over n uniformly spaced points.

    For even n (odd interval count) reproduces old scipy `simps(..., even='avg')`:
    the average of {Simpson on first n-1 points + trapezoid on the last interval}
    and {trapezoid on the first interval + Simpson on the last n-1 points}.
    This is the rule applied to the 50-node velocity integral at
    victor/ccf_model.py:570,690.
    """
    def basic(npts):
        # Simpson weights for odd npts (even interval count)
        w = np.zeros(npts)
        w[0:npts - 2:2] += 1.0
        w[1:npts - 1:2] += 4.0
        w[2:npts:2] += 1.0
        return w / 3.0

    if n % 2 == 1:
        w = basic(n)
    else:
        w1 = np.zeros(n)
        w1[:n - 1] = basic(n - 1)
        w1[-2:] += 0.5                # trapezoid on last interval
        w2 = np.zeros(n)
        w2[1:] = basic(n - 1)
        w2[:2] += 0.5                 # trapezoid on first interval
        w = 0.5 * (w1 + w2)
    return w * dx



def gauss_legendre(n: int, a: float = -1.0, b: float = 1.0):
    """Gauss-Legendre nodes and weights on [a, b]."""
    x, w = np.polynomial.legendre.leggauss(n)
    xm, xr = 0.5 * (b + a), 0.5 * (b - a)
    return xm + xr * x, xr * w
