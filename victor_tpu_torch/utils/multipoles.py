"""Legendre multipole <-> f(r, mu) transforms (victor/utils.py:9-95 parity).

The port of `victor_tpu/utils/multipoles.py`: host-side numpy utilities used
at data-preparation time with the reference's exact signatures and
conventions; the hot-path equivalents live in `victor_tpu_torch.ops` as
precomputed projection matrices.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..ops.integrate import trapz_weights
from ..ops.legendre import legendre_p


def multipoles_from_fn(frmu, r, ell: Sequence[int] = (0, 2, 4),
                       even: bool = True, npts: int = 200) -> dict:
    """Legendre multipoles of f(r, mu) via trapezoid quadrature
    (victor/utils.py:9-58).

    `even=True` integrates mu over [0, 1] with factor (2l+1) (valid for
    functions even in mu, and safe for interpolators built on [0, 1]);
    `even=False` integrates [-1, 1] with factor (2l+1)/2. Accepts callables
    returning either 1D arrays over mu or interp2d-style (len(mu), 1) grids.
    Returns {str(l): array over r}.
    """
    ell = np.atleast_1d(ell)
    if even:
        mu = np.linspace(0.0, 1.0, npts)
        factors = (2 * ell + 1).astype(float)
    else:
        mu = np.linspace(-1.0, 1.0, npts)
        factors = (2 * ell + 1) / 2.0
    w = trapz_weights(mu)
    r = np.atleast_1d(r)
    out = {}
    for i, l in enumerate(ell):
        lw = factors[i] * w * legendre_p(int(l), mu)
        vals = np.empty(len(r))
        for j, rj in enumerate(r):
            y = np.asarray(frmu(rj, mu))
            if y.ndim == 2:                    # interp2d convention (n_mu, 1)
                y = y.T[0]
            vals[j] = np.dot(y.reshape(-1), lw)
        out[f'{int(l)}'] = vals
    return out


def fn_from_multipoles(r, poles, multipoles, npts: int = 200):
    """Rebuild f(r, mu) from multipole arrays (victor/utils.py:60-95).

    `multipoles` is (len(poles), len(r)). Returns a callable with the old
    scipy.interp2d convention the reference returns: f(r, mu) evaluated on
    the tensor grid with shape (len(mu), len(r)).
    """
    poles = [poles] if isinstance(poles, (int, np.integer)) else list(poles)
    multipoles = np.atleast_2d(np.asarray(multipoles, dtype=float))
    if multipoles.shape != (len(poles), len(r)):
        raise ValueError(f'Wrong shape of multipoles: expected '
                         f'({len(poles)}, {len(r)}), but received '
                         f'{multipoles.shape}')
    mu = np.linspace(-1.0, 1.0, npts)
    grid = np.zeros((len(mu), len(r)))
    for i, l in enumerate(poles):
        grid += legendre_p(int(l), mu)[:, None] * multipoles[i]

    from ..api import Interp2D
    # the reference returns si.interp2d(r, mu, grid) with its default
    # *linear* interpolation (victor/utils.py:94)
    return Interp2D(np.asarray(r, dtype=float), mu, grid, kind='linear')