"""Background expansion rate E(z) for flat or curved LCDM.

Only what `io.tables.build_tables` needs for 1/(aH): the constructor and
`Ez` of `victor_tpu/models/cosmology.py:17-57`, in numpy. The distance, BAO
and growth toolkit of the JAX class is still to be ported (ROADMAP Queue 1
item 9).
"""

from __future__ import annotations

import numpy as np

C_KMS = 299792.458  # speed of light in km/s


class BackgroundCosmology:
    """Parameters mirror the reference config vocabulary
    (victor/cosmology.py:16-33): `Omega_m`, `Omega_K`, `H0` (or `h`),
    `sound_horizon`, `sigma8`."""

    def __init__(self, cosmology=None):
        cosmology = cosmology or {}
        self.c = C_KMS
        self.OmegaM = cosmology.get('Omega_m', 0.31)
        self.OmegaK = cosmology.get('Omega_K', 0)
        self.OmegaL = 1 - self.OmegaM - self.OmegaK
        self.H0 = cosmology.get('H0', 100 * cosmology.get('h', 0.675))
        self.rd = cosmology.get('sound_horizon', 148.1)
        self.sigma8 = cosmology.get('sigma8', 0.81)

    def Ez(self, z):
        z = np.asarray(z, dtype=float)
        return (self.OmegaM * (1 + z) ** 3 + self.OmegaK * (1 + z) ** 2
                + self.OmegaL) ** 0.5
