"""Synthetic-data machinery: mock draws from the fitted generative model.

The port of `victor_tpu/sampling/mocks.py`. Shared by the
parametric-bootstrap debiasing in `optimize.parametric_bootstrap`: one
implementation of "draw a data vector from N(t(theta), C(beta)) and graft
it into a bundle" so every consumer generates mocks identically. The
reference package has no analogue (mock validation there is manual).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch


def shift_datavector(bundle, delta):
    """Bundle with the data vector shifted by `delta` (n_ell_s * n_s,) at
    EVERY beta grid point: a constant shift moves only the constant PCHIP
    coefficient (interpolation is linear in the table values).

    A JointBundle is shifted per quantile: `delta` (jb.ndata,) is split at
    the stacked-vector block boundaries and each sub-bundle shifted with
    its own slice."""
    from ..likelihood.multiquantile import JointBundle
    if isinstance(bundle, JointBundle):
        out, off = [], 0
        for b in bundle.bundles:
            D = b.spec.n_s * len(b.spec.poles_s)
            out.append(shift_datavector(b, delta[off:off + D]))
            off += D
        return dataclasses.replace(bundle, bundles=tuple(out))
    t = bundle.tables
    if bundle.spec.fixed_data:
        base = t.data_mult_fixed
        d2 = base + torch.as_tensor(np.asarray(delta), dtype=base.dtype,
                                    device=base.device).reshape(base.shape)
        t2 = dataclasses.replace(t, data_mult_fixed=d2)
    else:
        c = t.data_mult_pchip_c
        d2 = c.clone()
        d2[:, 0] = c[:, 0] + torch.as_tensor(
            np.asarray(delta), dtype=c.dtype,
            device=c.device).reshape(c.shape[2:])[None]
        t2 = dataclasses.replace(t, data_mult_pchip_c=d2)
    return dataclasses.replace(bundle, tables=t2)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


def mock_setup(bundle, fiducial: Dict) -> Tuple[np.ndarray, np.ndarray,
                                                np.ndarray]:
    """Mock-generation ingredients (tvec, dvec, L) at a parameter point.

    tvec = theory vector at the fiducial, dvec = stored data vector at the
    fiducial beta, L = Cholesky factor of the covariance there (numpy, on
    the host). A mock is tvec + L @ xi; graft it with
    shift_datavector(bundle, mock - dvec)."""
    from ..likelihood.core import (interpolated_covariance,
                                   multipole_datavector)
    from ..likelihood.multiquantile import (JointBundle, joint_covariance,
                                            joint_datavector,
                                            joint_theory_vector)
    from ..models.ccf_theory import theory_vector

    if isinstance(bundle, JointBundle):
        ref = bundle.icov
    else:
        ref = bundle.tables.iaH
    params = {k: torch.tensor([float(v)], dtype=ref.dtype, device=ref.device)
              for k, v in fiducial.items()}
    if isinstance(bundle, JointBundle):
        # joint generative model: stacked theory/data vectors and the FULL
        # cross-covariance (quantile noise is correlated through the
        # off-diagonal blocks — the thing the joint machinery exists for)
        tvec = _host(joint_theory_vector(bundle, params)[0])
        dvec = _host(joint_datavector(bundle, params)[0])
        cov = _host(joint_covariance(bundle, params['beta'])[0])
        return tvec, dvec, np.linalg.cholesky(cov)
    beta = params['beta']
    tvec = _host(theory_vector(bundle.tables, bundle.spec,
                               bundle.theory_opts, params)[0])
    dvec = _host(multipole_datavector(bundle.tables, bundle.spec, beta)[0])
    cov = _host(interpolated_covariance(bundle.tables, bundle.spec, beta)[0])
    return tvec, dvec, np.linalg.cholesky(cov)
