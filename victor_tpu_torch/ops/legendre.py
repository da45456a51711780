"""Legendre polynomials P_ell(mu) for the multipoles used in CCF analysis.

Closed forms for the hot orders (replacing scipy.special.legendre at
victor/ccf_model.py:683 and victor/utils.py:53) plus the Bonnet recurrence
for every other ell — the reference accepts ANY order through
scipy.special.legendre, so the multipole transforms (utils/multipoles.py)
must too. Works on numpy arrays and torch tensors alike.
"""

from __future__ import annotations


def legendre_p(ell: int, mu):
    mu2 = mu * mu
    if ell < 0:
        raise ValueError(f'Legendre order must be >= 0, got {ell}')
    if ell == 0:
        return mu * 0 + 1.0
    if ell == 1:
        return mu
    if ell == 2:
        return 1.5 * mu2 - 0.5
    if ell == 3:
        return (5.0 * mu2 - 3.0) * mu / 2.0
    if ell == 4:
        return ((35.0 * mu2 - 30.0) * mu2 + 3.0) / 8.0
    if ell == 6:
        return ((231.0 * mu2 - 315.0) * mu2 + 105.0) * mu2 / 16.0 - 5.0 / 16.0
    # Bonnet recurrence (l+1) P_{l+1} = (2l+1) mu P_l - l P_{l-1}: exact and
    # numerically stable upward in l for |mu| <= 1
    p_prev = ((35.0 * mu2 - 30.0) * mu2 + 3.0) / 8.0        # P_4
    p = (((63.0 * mu2 - 70.0) * mu2 + 15.0) * mu) / 8.0     # P_5
    if ell == 5:
        return p
    for order in range(5, ell):
        p, p_prev = ((2 * order + 1) * mu * p - order * p_prev) \
            / (order + 1), p
    return p
