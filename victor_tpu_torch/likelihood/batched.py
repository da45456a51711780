"""Batched likelihood evaluation: many parameter points per call.

The port of `victor_tpu/likelihood/batched.py:29-135`. The likelihood core
already carries a leading batch axis, so the batch is a tensor dimension in
place of `jax.vmap`; `chunk` bounds peak memory, since one f64 (n_v, q)
intermediate is 1.2 MB per parameter point at BOSS size. Every model and
option of the theory layer runs through it, in every perf mode.

Typical use::

    bundle = build_tables(cfg['model'], cfg['data'])      # on the card
    batched = make_batched_loglike(
        bundle, ['fsigma8', 'beta', 'sigma_v', 'epsilon'], chunk=64)
    lnl, chi2 = batched(theta)           # theta: (N, 4) -> (N,), (N,)
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from ..config import resolve_perf_mode
from ..io.tables import CCFModelBundle
from .core import log_likelihood


def theta_to_params(theta: torch.Tensor, param_names: Sequence[str],
                    base_params: Optional[Dict] = None) -> Dict:
    """Map parameter vectors (B, P) to the params dict of (B,) tensors the
    core consumes. `base_params` supplies fixed values (scalars or (B,)
    tensors); sampled entries override them."""
    B = theta.shape[0]
    params = {k: torch.as_tensor(v, dtype=theta.dtype,
                                 device=theta.device).expand(B).clone()
              for k, v in (base_params or {}).items()}
    columns = theta.T.contiguous()
    for i, name in enumerate(param_names):
        params[name] = columns[i]
    return params


def _as_theta(bundle: CCFModelBundle, theta) -> torch.Tensor:
    ref = bundle.tables.iaH
    return torch.as_tensor(theta, dtype=ref.dtype, device=ref.device)


def make_loglike(bundle: CCFModelBundle, param_names: Sequence[str],
                 base_params: Optional[Dict] = None,
                 opts_kw: Optional[Dict] = None, fit_kw: Optional[Dict] = None):
    """Scalar log-likelihood: theta (P,) -> (lnlike, chisq) as 0-d tensors.
    'auto' perf modes stay unresolved and evaluate exactly."""
    opts = bundle.theory_opts.replace(**(opts_kw or {}))
    fit = bundle.fit_opts.replace(**(fit_kw or {}))
    names = tuple(param_names)

    def fn(theta):
        th = _as_theta(bundle, theta)[None]
        lnl, chi2 = log_likelihood(bundle.tables, bundle.spec, opts, fit,
                                   theta_to_params(th, names, base_params))
        return lnl[0], chi2[0]

    return fn


def chunked(run, chunk: Optional[int]):
    """`run(theta) -> tuple of (N,) tensors`, evaluated in chunks of `chunk`
    rows when the batch is larger; the last chunk is padded with copies of
    the first point and the pad rows are discarded, so every chunk has the
    same shape. None evaluates the whole batch at once."""
    def fn(theta):
        n = theta.shape[0]
        if not chunk or n <= chunk:
            return run(theta)
        n_chunks = -(-n // chunk)
        pad = n_chunks * chunk - n
        if pad:
            theta = torch.cat([theta, theta[:1].expand(pad, -1)])
        outs = [run(theta[i * chunk:(i + 1) * chunk]) for i in range(n_chunks)]
        return tuple(torch.cat(o)[:n] for o in zip(*outs))
    return fn


def make_batched_loglike(bundle: CCFModelBundle, param_names: Sequence[str],
                         base_params: Optional[Dict] = None,
                         opts_kw: Optional[Dict] = None,
                         fit_kw: Optional[Dict] = None,
                         chunk: Optional[int] = None,
                         gradient_free: bool = True):
    """Batched log-likelihood: theta (N, P) -> ((N,), (N,)).

    `chunk` evaluates batches larger than `chunk` in chunks of that size
    (`chunked`). None evaluates the whole batch at once.

    'auto' perf modes resolve as in victor_tpu (config.resolve_perf_mode):
    on the default gradient-free path to streaming_eval='fast',
    dispersion_final='fast' and beta_covariance='factored'. Explicit values
    in `opts_kw` are kept.
    """
    opts = resolve_perf_mode(bundle.theory_opts.replace(**(opts_kw or {})),
                             gradient_free)
    fit = bundle.fit_opts.replace(**(fit_kw or {}))
    names = tuple(param_names)

    def run(th):
        return log_likelihood(bundle.tables, bundle.spec, opts, fit,
                              theta_to_params(th, names, base_params))

    fn = chunked(run, chunk)
    return lambda theta: fn(_as_theta(bundle, theta))
