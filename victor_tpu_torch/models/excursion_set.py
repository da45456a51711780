"""Excursion-set model hooks consumed by the theory core.

A thin indirection, as in victor_tpu, so `ccf_theory` has no import-time
dependency on the ESM pipeline (`models/esm.py`).
"""

from .esm import esm_delta_profiles, esm_s8z, esm_velocity_terms  # noqa: F401
