"""Batched likelihood evaluation: many parameter points per call.

The port of `victor_tpu/likelihood/batched.py:29-135`. The likelihood core
already carries a leading batch axis, so the batch is a tensor dimension in
place of `jax.vmap`; `chunk` bounds peak memory, since one f64 (n_v, q)
intermediate is 1.2 MB per parameter point at BOSS size. Every model and
option of the theory layer runs through it, in every perf mode.

`make_sharded_loglike` splits the batch over a device mesh
(parallel/mesh.py), the port of `victor_tpu/likelihood/batched.py:138-175`.

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
from ..parallel.mesh import _first_tensor, chunked, shard_devices, shard_map
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


def chunked_vmap(fn, chunk: int):
    """`torch.func.vmap(fn)` over the batch in chunks of `chunk` rows, the
    counterpart of `victor_tpu.likelihood.chunked_vmap`: `fn` maps one row
    theta[i] to a tensor or a tuple of tensors, and the returned function
    maps theta (N, ...) to the same with a leading N axis. A batch larger
    than `chunk` is cut into chunks of `chunk` rows, the last padded with
    copies of theta[:1] and the pad rows dropped (`parallel.mesh.chunked`);
    a smaller one is one call, which for a per-row `fn` gives the same rows.

    `fn` must be made of PyTorch operations that `torch.func.vmap` can
    batch. The port's likelihood makers are batched already (theta (N, P)
    in, (N,) out) and chunk through `parallel.mesh.chunked`, so they need no
    vmap: this is for per-row functions written against victor_tpu."""
    return chunked(torch.func.vmap(fn), chunk)


def make_batched_loglike(bundle: CCFModelBundle, param_names: Sequence[str],
                         base_params: Optional[Dict] = None,
                         opts_kw: Optional[Dict] = None,
                         fit_kw: Optional[Dict] = None,
                         chunk: Optional[int] = None,
                         gradient_free: bool = True):
    """Batched log-likelihood: theta (N, P) -> ((N,), (N,)), on the bundle's
    device: make_sharded_loglike with no mesh.

    `chunk` evaluates batches larger than `chunk` in chunks of that size
    (`chunked`). None evaluates the whole batch at once.

    'auto' perf modes resolve as in victor_tpu (config.resolve_perf_mode):
    on the default gradient-free path to streaming_eval='fast',
    dispersion_final='fast' and beta_covariance='factored'. Explicit values
    in `opts_kw` are kept.
    """
    return make_sharded_loglike(bundle, param_names, None,
                                base_params=base_params, opts_kw=opts_kw,
                                fit_kw=fit_kw, gradient_free=gradient_free,
                                chunk=chunk)


def sharded_call(run, tables, dtype, mesh, axis, chunk):
    """theta -> parallel.mesh.shard_map(run, tables, mesh, axis,
    chunk)(theta): theta (N, P) as `dtype` on the first device the axes
    span (with no mesh, the tables' device), N divisible by their device
    count (as a sharded jax.device_put requires); the results are gathered
    on that device."""
    devices = [_first_tensor(tables).device] if mesh is None else \
        shard_devices(mesh, axis)
    fn = shard_map(run, tables, mesh, axis, chunk)

    def call(theta):
        theta = torch.as_tensor(theta, dtype=dtype, device=devices[0])
        if theta.shape[0] % len(devices):
            raise ValueError(f'a batch of {theta.shape[0]} points does not '
                             f'split evenly over {len(devices)} devices')
        return fn(theta)

    return call


def make_sharded_loglike(bundle: CCFModelBundle, param_names: Sequence[str],
                         mesh, axis='walkers',
                         base_params: Optional[Dict] = None,
                         opts_kw: Optional[Dict] = None,
                         fit_kw: Optional[Dict] = None,
                         gradient_free: bool = True,
                         chunk: Optional[int] = None):
    """Batched log-likelihood sharded over a device mesh (parallel.Mesh):
    theta (N, P) -> ((N,), (N,)).

    The tables are replicated once per distinct device of `mesh`, now, not
    per call. theta is split into equal slices along the mesh axis `axis`
    (a name or a tuple of names; N must divide by the device count they
    span), every slice is evaluated on its device in chunks of `chunk`
    rows (as make_batched_loglike does; chunk k of every slice is issued
    before chunk k + 1 of any, and all before any is read back), and (lnL,
    chi2) are gathered on the first device; gradients flow back to every
    shard. Perf modes resolve as in make_batched_loglike. The tables and
    the mesh must lie on one device type. With `mesh` None the batch is
    evaluated on the bundle's device (make_batched_loglike).
    """
    opts = resolve_perf_mode(bundle.theory_opts.replace(**(opts_kw or {})),
                             gradient_free)
    fit = bundle.fit_opts.replace(**(fit_kw or {}))
    names = tuple(param_names)

    def run(tables, theta):
        return log_likelihood(tables, bundle.spec, opts, fit,
                              theta_to_params(theta, names, base_params))

    return sharded_call(run, bundle.tables, bundle.tables.iaH.dtype, mesh,
                        axis, chunk)
