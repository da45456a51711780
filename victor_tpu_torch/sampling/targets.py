"""Shared resolution of a likelihood target for the sampling layer.

The port of `victor_tpu/sampling/targets.py`. The samplers accept the same
target kinds: a single-dataset CCFModelBundle, a multi-quantile JointBundle,
a ProductTarget of independent members, or a callable params -> (lnlike,
aux). `resolve_target` is the one place that dispatches them. The particle
samplers (smc.py, nested.py) share two more pieces: `make_unbounded_wrappers`
(the batched likelihood and prior over the unbounded reparameterisation) and
`guarded_cholesky` (the jittered proposal factor with its diagonal
fallback).

Every function here works over a leading batch axis: params are dicts of
(B,) tensors and a callable target takes such a dict and returns (lnlike,
aux) as (B,) tensors. victor_tpu's JitFnCache, and the target identity
that keys it, have no counterpart: nothing is compiled, so there is nothing
to cache.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ProductTarget:
    """Product of INDEPENDENT dataset likelihoods at shared parameters:
    lnL(params) = sum over members (block-diagonal joint covariance, no
    cross-terms — for correlated datasets build a JointBundle with the full
    cross-covariance instead). Members are any target kind resolve_target
    accepts, resolved recursively."""
    members: tuple


def resolve_perf_kw(theory_opts_list, opts_kw: Optional[Dict],
                    gradient_free: bool) -> Optional[Dict]:
    """Resolve 'auto' perf modes into an opts_kw override dict.

    The JointBundle path applies `opts_kw` uniformly over every member
    bundle, so the resolution happens in kw space: a field is injected only
    when the caller didn't override it AND every member left it at 'auto'
    (a mixed explicit/auto mix is honored as-is). See
    config.resolve_perf_mode for the fast/exact policy and the opt-out.
    """
    from ..config import PERF_MODE_FIELDS, resolve_perf_mode
    kw = dict(opts_kw or {})
    autos = [f for f in PERF_MODE_FIELDS if f not in kw and
             all(getattr(o, f) == 'auto' for o in theory_opts_list)]
    if autos:
        # reuse the policy (and its log line) on a probe opts
        probe = resolve_perf_mode(theory_opts_list[0], gradient_free)
        kw.update({f: getattr(probe, f) for f in autos})
    return kw or None


def resolve_target(bundle, opts_kw: Optional[Dict], fit_kw: Optional[Dict],
                   gradient_free: bool = False
                   ) -> Tuple[object, callable]:
    """Returns (tables_arg, loglike(tbl, params) -> (lnl, aux)).

    `tables_arg` is what `loglike` reads its tables from.

    `gradient_free=True` declares that the returned loglike is only ever
    evaluated forward: 'auto' perf modes resolve to the posterior-validated
    fast modes (config.resolve_perf_mode); gradient-based consumers keep
    False, resolving 'auto' to 'exact'.
    """
    from ..likelihood.core import log_likelihood
    from ..likelihood.multiquantile import JointBundle, joint_log_likelihood

    if isinstance(bundle, ProductTarget):
        parts = [resolve_target(m, opts_kw, fit_kw, gradient_free)
                 for m in bundle.members]
        tables = tuple(p[0] for p in parts)
        fns = tuple(p[1] for p in parts)

        def loglike(tbl, params):
            vals = [fn(t, params) for fn, t in zip(fns, tbl)]
            lnl = sum(v[0] for v in vals)
            aux = sum(v[1] for v in vals)      # summed chi2 across members
            return lnl, aux
        return tables, loglike

    if is_callable_target(bundle):
        user_fn = bundle

        def loglike(tbl, params):
            return user_fn(params)
        return None, loglike

    if isinstance(bundle, JointBundle):
        jkw = resolve_perf_kw([b.theory_opts for b in bundle.bundles],
                              opts_kw, gradient_free)

        def loglike(tbl, params):
            return joint_log_likelihood(tbl, params, jkw, fit_kw)
        return bundle, loglike

    from ..config import resolve_perf_mode
    opts = resolve_perf_mode(bundle.theory_opts.replace(**(opts_kw or {})),
                             gradient_free)
    fit = bundle.fit_opts.replace(**(fit_kw or {}))
    spec = bundle.spec

    def loglike(tbl, params):
        return log_likelihood(tbl, spec, opts, fit, params)
    return bundle.tables, loglike



def is_callable_target(bundle) -> bool:
    """Whether `bundle` is a bare callable params -> (lnlike, aux), whose aux
    is an arbitrary statistic rather than the chi2 column of a bundle
    target (the chain files name it `aux_0`, not `chi2_ccf_correct`)."""
    from ..likelihood.multiquantile import JointBundle
    return callable(bundle) and not hasattr(bundle, 'tables') \
        and not isinstance(bundle, (JointBundle, ProductTarget))


def make_unbounded_wrappers(space, loglike):
    """(lnprior, batched_lnlike) over the unbounded reparameterisation
    y = space.to_unbounded(theta), for the particle samplers (smc.py,
    nested.py).

    lnprior(y (N, ndim)) -> (N,) includes the reparameterisation's
    log-Jacobian; batched_lnlike(tbl, y (N, ndim)) -> (lnl (N,), aux (N, 1))
    maps non-finite lnL to -inf. It evaluates the batch whole: the samplers
    chunk it, and shard it over a mesh, through
    `parallel.mesh.shard_map(batched_lnlike, tbl, mesh, axes, chunk)`."""
    def lnprior(y):
        return space.log_prior(space.to_bounded(y)) + space.log_jacobian(y)

    def batched_lnlike(tbl, y):
        lnl, aux = loglike(tbl, space.full_params(space.to_bounded(y)))
        return (torch.where(torch.isfinite(lnl), lnl, -math.inf),
                aux.reshape(y.shape[0], 1))

    return lnprior, batched_lnlike


def guarded_cholesky(w: torch.Tensor, y: torch.Tensor, scale=1.0):
    """Proposal Cholesky of the w-weighted covariance of y (N, d), times the
    Haario 2.38/sqrt(d) factor and `scale`.

    The jitter scales with trace(C)/d (a fixed 1e-10 is below f32 rounding
    on late-stage near-degenerate particle clouds, where the Cholesky can
    NaN and silently freeze every mutation), and a diagonal fallback covers
    a factor that is not finite; the choice is a select on the device, with
    no read to the host."""
    from .hmc import cholesky_or_nan
    d = y.shape[1]
    mu = torch.einsum('i,ij->j', w, y)
    yc = y - mu
    C = torch.einsum('i,ij,ik->jk', w, yc, yc)
    jitter = torch.clamp(1e-6 * torch.trace(C) / d, min=1e-30)
    C = C + jitter * torch.eye(d, dtype=C.dtype, device=C.device)
    chol = cholesky_or_nan(C)
    chol = torch.where(torch.isfinite(chol).all(), chol,
                       torch.diag(torch.sqrt(torch.diag(C))))
    return chol * (2.38 / math.sqrt(d)) * scale
