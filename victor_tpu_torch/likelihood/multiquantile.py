"""Density-split multi-quantile joint fits: stacked CCF data vectors with a
full cross-covariance, batched over parameter points.

The port of `victor_tpu/likelihood/multiquantile.py`. Density-split
analyses fit several quantile-defined centre sets (e.g. DS1-DS5) at once:
each quantile has its own model inputs and redshift-space data vector, and
one joint covariance couples all of them. A JointBundle carries one table
set per quantile plus the joint (possibly beta-dependent) covariance; the
joint likelihood reuses the single-dataset theory and likelihood helpers
per quantile.

Per-quantile parameter overrides use a `<name>__q<i>` suffix: `sigma_v__q0`
overrides `sigma_v` for quantile 0 only (each quantile can have its own
dispersion amplitude / AP nuisances while sharing cosmology/growth).

Config schema::

    joint:
      quantiles:          # list of single-dataset blocks (no covariance)
        - model: {...}
          data: {redshift_space_ccf: {...}}
        - ...
      covariance_matrix:  # joint cross-covariance over the stacked vector
        data_file: ...
        cov_key: covmat
        fixed_beta: False
        beta_key: beta
      likelihood: {form: sellentin, nmocks: 1000, nparams: ...}
      beta_interpolation: datavector

Parameters are dicts of (B,) tensors and every function returns (B,)
results, as in likelihood/core.py.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import FitOptions, fit_options_from_config
from ..errors import InputError
from ..io.loaders import load_key_value_file
from ..io.tables import (CCFModelBundle, _build_arrays, _pencil_precompute,
                         _tables_from_arrays, _target_device)
from ..models.ccf_theory import theory_vector
from .batched import sharded_call, theta_to_params
from .core import (_apply_form, _factored_chi_squared, _interp_matrix_stack,
                   _like_factor, _pencil_like_factor, multipole_datavector)


@dataclasses.dataclass(frozen=True)
class JointBundle:
    """Per-quantile bundles + the joint covariance over the stacked vector."""
    bundles: Tuple[CCFModelBundle, ...]
    cov: torch.Tensor                   # (D, D) or (n_b, D, D)
    icov: torch.Tensor
    beta_cov: Optional[torch.Tensor]
    fixed_covmat: bool
    fit_opts: FitOptions
    ndata: int
    # pencil factorization of the joint beta-covariance stack (see
    # io/tables.py:_pencil_precompute): O(D) log-det per evaluation in place
    # of a (D, D) slogdet as D = N*60 grows with the quantile count
    cov_logdet: Optional[torch.Tensor] = None     # (n_b,)
    cov_pencil: Optional[torch.Tensor] = None     # (n_b, D)

    def to(self, device, dtype) -> 'JointBundle':
        """A copy with every tensor on `device` as `dtype`."""
        def move(t):
            return None if t is None else t.to(device, dtype)
        return dataclasses.replace(
            self, bundles=tuple(b.to(device, dtype) for b in self.bundles),
            cov=move(self.cov), icov=move(self.icov),
            beta_cov=move(self.beta_cov), cov_logdet=move(self.cov_logdet),
            cov_pencil=move(self.cov_pencil))


def build_joint_tables(joint: Dict, base_dir: str = '', device='cuda',
                       dtype: torch.dtype = torch.float64) -> JointBundle:
    """Build a JointBundle from a `joint:` config block (schema above).

    Every table is built in float64 numpy on the host, then moved to
    `device` as `dtype` once: the card unless `device='cpu'` is asked for."""
    device = _target_device(device)
    quantiles = joint.get('quantiles')
    if not quantiles:
        raise InputError('joint fit requires a non-empty quantiles: list')
    built = []
    for qi, q in enumerate(quantiles):
        model = dict(q['model'])
        data = dict(q.get('data') or {})
        if not data:
            # a data-less quantile would inflate D from the model r grid
            raise InputError(f'joint quantile {qi} needs a data: block '
                             '(its slice of the stacked data vector)')
        model.setdefault('dir', base_dir)
        data.setdefault('dir', base_dir)
        if 'covariance_matrix' in data:
            raise InputError('quantile data blocks must not carry their own '
                             'covariance_matrix; supply the joint one')
        built.append(_build_arrays(model, data, 100, 50))

    D = sum(spec.n_s * len(spec.poles_s) for _, spec, _, _ in built)

    covariance = joint.get('covariance_matrix')
    if not covariance:
        raise InputError('joint fit requires a covariance_matrix block')
    cov_fn = os.path.join(base_dir, covariance['data_file'])
    if not os.path.isfile(cov_fn):
        raise InputError(f'Joint covariance file {cov_fn} not found')
    cdict = load_key_value_file(cov_fn)
    cov_key = covariance.get('cov_key', 'covmat')
    if cov_key not in cdict:
        raise InputError(f'Key {cov_key} not found in file {cov_fn}')
    cov = np.asarray(cdict[cov_key], dtype=np.float64)

    fixed_covmat = covariance.get('fixed_beta', True)
    beta_cov = None
    if not fixed_covmat:
        beta_key = covariance.get('beta_key', 'beta')
        if beta_key not in cdict:
            raise InputError(f'Joint covariance beta key {beta_key} not found')
        beta_cov = np.asarray(cdict[beta_key], dtype=np.float64)
        if cov.shape != (len(beta_cov), D, D):
            raise InputError(f'Joint covariance shape {cov.shape} does not '
                             f'match ({len(beta_cov)}, {D}, {D})')
        if not np.all(np.diff(beta_cov) > 0):
            # _interp_matrix_stack's searchsorted silently mis-interpolates
            # on an unsorted grid
            raise InputError('Joint covariance beta grid must be strictly '
                             'increasing')
    elif cov.shape != (D, D):
        raise InputError(f'Joint covariance shape {cov.shape} does not match '
                         f'({D}, {D})')

    fit_opts = fit_options_from_config(joint)
    if fit_opts.beta_interpolation == 'likelihood':
        # the bracketing grid is ambiguous when quantiles carry their own
        # beta grids; refuse rather than silently fall back to datavector
        raise InputError("beta_interpolation: 'likelihood' is not supported "
                         "for joint multi-quantile fits; use 'datavector'")
    cov_logdet = cov_pencil = None
    if not fixed_covmat:
        cov_logdet, cov_pencil = _pencil_precompute(cov)

    def move(a):
        return None if a is None else torch.tensor(a).to(device, dtype)

    return JointBundle(
        bundles=tuple(CCFModelBundle(
            tables=_tables_from_arrays(arrays, device, dtype), spec=spec,
            theory_opts=theory_opts, fit_opts=fit)
            for arrays, spec, theory_opts, fit in built),
        cov=move(cov), icov=move(np.linalg.inv(cov)), beta_cov=move(beta_cov),
        fixed_covmat=fixed_covmat, fit_opts=fit_opts, ndata=D,
        cov_logdet=move(cov_logdet), cov_pencil=move(cov_pencil))


def quantile_params(params: Dict, i: int) -> Dict:
    """Resolve `<name>__q<i>` per-quantile overrides for quantile i."""
    suffix = f'__q{i}'
    out = {k: v for k, v in params.items() if '__q' not in k}
    for k, v in params.items():
        if k.endswith(suffix):
            out[k[: -len(suffix)]] = v
    return out


def _check_quantile_indices(params: Dict, n_quantiles: int) -> None:
    """A `__q<i>` override whose index matches no quantile would otherwise
    be silently dropped by quantile_params — a dead coordinate the
    likelihood is exactly flat in."""
    for k in params:
        if '__q' not in k:
            continue
        name, _, idx = k.rpartition('__q')
        if not name or not idx.isdigit() or int(idx) >= n_quantiles:
            raise InputError(
                f"per-quantile override '{k}' matches no quantile: this "
                f'joint fit has {n_quantiles} quantiles '
                f'(valid suffixes __q0..__q{n_quantiles - 1})')


def _zeros_like_batch(params: Dict) -> torch.Tensor:
    return torch.zeros_like(next(iter(params.values())))


def joint_theory_vector(jb: JointBundle, params: Dict,
                        opts_kw: Optional[Dict] = None) -> torch.Tensor:
    """Stacked theory vectors over quantiles, (B, jb.ndata)."""
    _check_quantile_indices(params, len(jb.bundles))
    parts = []
    for i, b in enumerate(jb.bundles):
        opts = b.theory_opts.replace(**(opts_kw or {}))
        parts.append(theory_vector(b.tables, b.spec, opts,
                                   quantile_params(params, i)))
    return torch.cat(parts, dim=1)


def joint_datavector(jb: JointBundle, params: Dict) -> torch.Tensor:
    parts = []
    for i, b in enumerate(jb.bundles):
        p = quantile_params(params, i)
        if 'beta' not in p and not b.spec.fixed_data:
            raise InputError(f'Quantile {i} has a beta-dependent data vector '
                             f'but neither beta nor beta__q{i} was supplied')
        beta = p['beta'] if 'beta' in p else _zeros_like_batch(params)
        parts.append(multipole_datavector(b.tables, b.spec, beta))
    return torch.cat(parts, dim=1)


def joint_covariance(jb: JointBundle, beta) -> torch.Tensor:
    if jb.fixed_covmat:
        return jb.cov.expand(beta.shape[0], -1, -1)
    return _interp_matrix_stack(jb.beta_cov, jb.cov, beta)


def joint_precision(jb: JointBundle, beta) -> torch.Tensor:
    if jb.fixed_covmat:
        return jb.icov.expand(beta.shape[0], -1, -1)
    return _interp_matrix_stack(jb.beta_cov, jb.icov, beta)


def _joint_use_factored(jb: JointBundle, opts_kw: Optional[Dict]) -> bool:
    """Joint-path analogue of core._use_factored: the resolved mode rides
    in opts_kw (resolve_perf_kw applies it uniformly); absent that, a
    uniform explicit setting across member bundles is honored."""
    mode = (opts_kw or {}).get('beta_covariance')
    if mode is None:
        modes = {b.theory_opts.beta_covariance for b in jb.bundles}
        mode = modes.pop() if len(modes) == 1 else 'auto'
    return (mode == 'factored' and not jb.fixed_covmat
            and jb.cov_logdet is not None)


def joint_chi_squared(jb: JointBundle, params: Dict,
                      opts_kw: Optional[Dict] = None):
    """(chi2 (B,), covariance (B, D, D) or None on the factored path)."""
    tv = joint_theory_vector(jb, params, opts_kw)
    dv = joint_datavector(jb, params)
    if 'beta' not in params and not jb.fixed_covmat:
        # the joint covariance interpolates on the GLOBAL beta (per-quantile
        # beta__q<i> overrides do not apply to the shared matrix)
        raise InputError('Need a global beta to interpolate the '
                         'beta-dependent joint covariance')
    beta = params['beta'] if 'beta' in params else _zeros_like_batch(params)
    diff = tv - dv
    if _joint_use_factored(jb, opts_kw):
        # contract against every grid precision, scalar-interpolate: no
        # (B, N*60, N*60) blend; joint_log_likelihood takes the pencil
        # log-det
        return _factored_chi_squared(jb.beta_cov, jb.icov, diff, beta), None
    cov = joint_covariance(jb, beta)
    icov = joint_precision(jb, beta)
    chisq = torch.einsum('bi,bij,bj->b', diff, icov, diff)
    return chisq, cov


def joint_log_likelihood(jb: JointBundle, params: Dict,
                         opts_kw: Optional[Dict] = None,
                         fit_kw: Optional[Dict] = None):
    """(lnlike, chisq), each (B,), for the joint multi-quantile fit; the
    likelihood forms and guards of the single-dataset path over the stacked
    vector."""
    fit = jb.fit_opts.replace(**(fit_kw or {}))
    if fit.beta_interpolation == 'likelihood':
        # also refused at build time; re-checked so a runtime fit_kw
        # override cannot silently fall back to datavector
        raise InputError("beta_interpolation: 'likelihood' is not supported "
                         "for joint multi-quantile fits; use 'datavector'")
    chisq, cov = joint_chi_squared(jb, params, opts_kw)
    if not jb.fixed_covmat:
        if cov is None:   # factored path: pencil logdet, no blend
            lf, ok = _pencil_like_factor(jb.beta_cov, jb.cov_logdet,
                                         jb.cov_pencil, params['beta'])
        else:
            lf, ok = _like_factor(cov)
    else:
        lf = torch.zeros_like(chisq)
        ok = torch.ones_like(chisq, dtype=torch.bool)
    lnlike = _apply_form(chisq, lf, fit, jb.ndata)
    bad = ~ok | torch.isnan(lnlike)
    return (torch.where(bad, -math.inf, lnlike),
            torch.where(bad, math.inf, chisq))


def make_batched_joint_loglike(jb: JointBundle, param_names: Sequence[str],
                               base_params: Optional[Dict] = None,
                               opts_kw: Optional[Dict] = None,
                               fit_kw: Optional[Dict] = None,
                               chunk: Optional[int] = None,
                               gradient_free: bool = True):
    """Batched joint likelihood: theta (N, P) -> ((N,), (N,)), on the
    bundle's device: make_sharded_joint_loglike with no mesh.

    `chunk` bounds peak memory as in batched.make_batched_loglike: a joint
    fit's per-point working set is n_quantiles times the single-dataset
    one. `gradient_free=True` resolves 'auto' perf modes to the validated
    fast modes (targets.resolve_perf_kw)."""
    return make_sharded_joint_loglike(jb, param_names, None,
                                      base_params=base_params,
                                      opts_kw=opts_kw, fit_kw=fit_kw,
                                      gradient_free=gradient_free,
                                      chunk=chunk)


def make_sharded_joint_loglike(jb: JointBundle, param_names: Sequence[str],
                               mesh, axis='walkers',
                               base_params: Optional[Dict] = None,
                               opts_kw: Optional[Dict] = None,
                               fit_kw: Optional[Dict] = None,
                               gradient_free: bool = True,
                               chunk: Optional[int] = None):
    """The joint likelihood with the batch sharded over a device mesh: the
    joint analogue of batched.make_sharded_loglike. The per-quantile tables
    and the joint covariance stack are replicated once per distinct device
    of `mesh`; theta (N, P) is split into equal slices along `axis` (a mesh
    axis name or a tuple of them), N divisible by the device count the axes
    span; each device contracts its slice against its replica in chunks of
    `chunk` rows, issued in turn across the devices, and (lnL, chi2) are
    gathered on the first of those devices. With `mesh` None the batch is
    evaluated on the bundle's device (make_batched_joint_loglike)."""
    from ..sampling.targets import resolve_perf_kw

    opts_kw = resolve_perf_kw([b.theory_opts for b in jb.bundles],
                              opts_kw, gradient_free)
    names = tuple(param_names)

    def run(tbl, theta):
        return joint_log_likelihood(
            tbl, theta_to_params(theta, names, base_params), opts_kw, fit_kw)

    return sharded_call(run, jb, jb.icov.dtype, mesh, axis, chunk)
