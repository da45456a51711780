"""Parameter-space specification parsed from cobaya-style `params:` blocks.

The port of `victor_tpu/sampling/priors.py`. The reference delegates priors,
reference distributions, proposals and derived parameters to cobaya
(config/boss_cobaya_config.yaml:50-97, victor/likelihoods/CCFLikelihood.yaml:
8-40). Here the same YAML vocabulary is parsed into a `ParamSpace` whose
`log_prior` and transforms are tensor functions over a leading batch axis,
evaluated on the device beside the batched likelihood.

Supported per-parameter forms:
  name:                      -> sampled, spec from an outer default (or error)
  name: 1.9                  -> fixed value
  name: {prior: {dist: uniform, min, max}, ref: {...}, proposal, latex}
  name: {prior: {dist: norm, loc, scale}, ...}
  name: {prior: {dist: loguniform, min, max}, ...}    (scipy a/b also accepted)
  name: {prior: {dist: halfnorm, loc, scale}, ...}
  name: {value: "lambda a, b: ..."}   -> derived from other params
  name: {derived: True}      -> derived output (filled by the likelihood)

A scalar ref (`ref: 0.47`) or a zero-width ref would start every ensemble
walker at the identical point, making the stretch move permanently degenerate
(proposal == current point for all walkers); the start scatter falls back to
the `proposal` width, else 1% of the prior scale.

Draws (`sample_prior`, `sample_ref`) take a `torch.Generator` and come out on
its device in float64.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..errors import InputError


@dataclasses.dataclass(frozen=True)
class SampledParam:
    name: str
    dist: str                 # 'uniform' | 'norm' | 'loguniform' | 'halfnorm'
    lo: float                 # min (uniform/loguniform) / loc (norm/halfnorm)
    hi: float                 # max (uniform/loguniform) / scale (norm/halfnorm)
    ref_dist: str = 'prior'
    ref_loc: float = 0.0
    ref_scale: float = 1.0
    ref_lo: float = 0.0       # min/max for uniform/loguniform refs
    ref_hi: float = 0.0
    proposal: Optional[float] = None
    latex: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class DerivedParam:
    name: str
    fn: Callable              # params dict -> value
    argnames: Tuple[str, ...]
    latex: Optional[str] = None
    src: str = ''             # raw lambda text (name + argnames alone would
                              # alias two lambdas with different bodies)


def _as_tensor_args(fn):
    def call(*args):
        return fn(*[a if isinstance(a, torch.Tensor)
                    else torch.as_tensor(a, dtype=torch.float64) for a in args])
    return call


class _LambdaNumpy:
    """What a derived-parameter lambda reaches as `np` or `jnp`: the numpy
    names cobaya configs use, bound to torch functions so the lambda runs on
    the tensors of the batch. Any other attribute raises InputError."""

    pi = math.pi
    e = math.e

    def __init__(self):
        for name, fn in {
                'sqrt': torch.sqrt, 'exp': torch.exp, 'expm1': torch.expm1,
                'log': torch.log, 'log1p': torch.log1p, 'log10': torch.log10,
                'log2': torch.log2, 'sin': torch.sin, 'cos': torch.cos,
                'tan': torch.tan, 'arcsin': torch.asin, 'arccos': torch.acos,
                'arctan': torch.atan, 'arctan2': torch.atan2,
                'sinh': torch.sinh, 'cosh': torch.cosh, 'tanh': torch.tanh,
                'abs': torch.abs, 'square': torch.square, 'power': torch.pow,
                'minimum': torch.minimum, 'maximum': torch.maximum,
                'where': torch.where, 'clip': torch.clamp}.items():
            setattr(self, name, _as_tensor_args(fn))

    def __getattr__(self, name):
        if name.startswith('__'):
            raise AttributeError(name)
        raise InputError(
            f"derived-parameter lambda uses np.{name}, which the port does not "
            'provide; available: ' + ', '.join(sorted(vars(self))
                                               + ['e', 'pi']))


_NP = _LambdaNumpy()


def _parse_lambda(expr: str) -> Tuple[Callable, Tuple[str, ...]]:
    """Compile a cobaya-style 'lambda a, b: ...' derived-parameter string,
    with `np`/`jnp` bound to the torch namespace above and `math` to math."""
    expr = expr.strip()
    if not expr.startswith('lambda'):
        raise InputError(f"Derived parameter value must be a lambda string, got {expr!r}")
    header = expr[len('lambda'):expr.index(':')]
    argnames = tuple(a.strip() for a in header.split(',') if a.strip())
    fn = eval(expr, {'np': _NP, 'jnp': _NP, 'math': math})  # noqa: S307 (trusted config)
    return fn, argnames


class ParamSpace:
    """Sampled + fixed + derived parameters with tensor prior/ref functions."""

    def __init__(self, params_block: Dict):
        self.sampled: List[SampledParam] = []
        self.fixed: Dict[str, float] = {}
        self.derived: List[DerivedParam] = []
        for name, spec in (params_block or {}).items():
            if spec is None:
                raise InputError(
                    f"Parameter '{name}' has no specification; give a prior, a "
                    "fixed value, or a derived lambda")
            if isinstance(spec, (int, float)):
                self.fixed[name] = float(spec)
                continue
            if not isinstance(spec, dict):
                raise InputError(f"Bad specification for parameter '{name}': {spec!r}")
            if spec.get('derived') is True:
                continue  # output-only derived (e.g. chi2), produced by the runner
            if 'value' in spec:
                val = spec['value']
                if isinstance(val, str):
                    fn, args = _parse_lambda(val)
                    self.derived.append(DerivedParam(name, fn, args,
                                                     spec.get('latex'), val))
                else:
                    self.fixed[name] = float(val)
                continue
            prior = spec.get('prior')
            if prior is None:
                raise InputError(f"Parameter '{name}' needs a prior, value, or derived flag")
            dist = prior.get('dist', 'uniform')
            if dist in ('uniform', 'loguniform'):
                # scipy.stats.loguniform uses a/b; cobaya configs write min/max
                lo = float(prior['min'] if 'min' in prior else prior['a'])
                hi = float(prior['max'] if 'max' in prior else prior['b'])
                if dist == 'loguniform' and lo <= 0:
                    raise InputError(f"loguniform prior for '{name}' needs min > 0")
            elif dist in ('norm', 'halfnorm'):
                lo = float(prior.get('loc', 0.0))
                hi = float(prior.get('scale', 1.0))
            else:
                raise InputError(f"Unsupported prior dist '{dist}' for '{name}'")
            ref = spec.get('ref')
            if ref is None:
                ref = {}
            if isinstance(ref, (int, float)):   # scalar ref, incl. `ref: 0`
                ref = {'dist': 'norm', 'loc': float(ref), 'scale': 0.0}
            # a ref block without an explicit dist means norm in cobaya
            # ({loc, scale} shorthand); an empty/missing ref falls back to
            # prior draws; unsupported dists error
            ref_dist = ref.get('dist', 'norm' if ref else 'prior')
            if ref_dist not in ('prior', 'norm', 'uniform', 'loguniform',
                                'halfnorm'):
                raise InputError(
                    f"Unsupported ref dist '{ref_dist}' for '{name}'")
            ref_lo = ref_hi = 0.0
            if ref_dist in ('uniform', 'loguniform'):
                ref_lo = float(ref['min'] if 'min' in ref else ref['a'])
                ref_hi = float(ref['max'] if 'max' in ref else ref['b'])
            ref_scale = float(ref.get('scale', 1.0))
            if ref_dist in ('norm', 'halfnorm') and ref_scale == 0.0:
                # zero start scatter would collapse the walker ensemble (see
                # module docstring); proposal width, else 1% of prior scale
                if spec.get('proposal'):
                    ref_scale = float(spec['proposal'])
                elif dist in ('uniform', 'loguniform'):
                    ref_scale = 0.01 * (hi - lo)
                else:
                    ref_scale = 0.01 * hi
            self.sampled.append(SampledParam(
                name=name, dist=dist, lo=lo, hi=hi,
                ref_dist=ref_dist,
                ref_loc=float(ref.get('loc', 0.0)),
                ref_scale=ref_scale,
                ref_lo=ref_lo, ref_hi=ref_hi,
                proposal=spec.get('proposal'),
                latex=spec.get('latex'),
            ))

    # ------------------------------------------------------------------
    @property
    def names(self) -> List[str]:
        return [p.name for p in self.sampled]

    @property
    def ndim(self) -> int:
        return len(self.sampled)

    def bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        lo = np.array([p.lo if p.dist in ('uniform', 'loguniform', 'halfnorm')
                       else -np.inf for p in self.sampled])
        hi = np.array([p.hi if p.dist in ('uniform', 'loguniform')
                       else np.inf for p in self.sampled])
        return lo, hi

    # ------------------------------------------------------------------
    def log_prior(self, theta: torch.Tensor) -> torch.Tensor:
        """Log prior density at theta (..., ndim); -inf outside support."""
        lp = theta.new_zeros(theta.shape[:-1])
        for i, p in enumerate(self.sampled):
            x = theta[..., i]
            if p.dist == 'uniform':
                inside = (x >= p.lo) & (x <= p.hi)
                lp = torch.where(inside, lp - math.log(p.hi - p.lo), -math.inf)
            elif p.dist == 'loguniform':
                inside = (x >= p.lo) & (x <= p.hi)
                lp = torch.where(
                    inside, lp - torch.log(x) - math.log(math.log(p.hi / p.lo)),
                    -math.inf)
            elif p.dist == 'halfnorm':
                inside = x >= p.lo
                z = (x - p.lo) / p.hi
                dens = -0.5 * (z * z) - math.log(p.hi) \
                    + 0.5 * math.log(2.0 / math.pi)
                lp = torch.where(inside, lp + dens, -math.inf)
            else:  # norm
                z = (x - p.lo) / p.hi
                lp = lp - 0.5 * (z * z) \
                    - math.log(p.hi) - 0.5 * math.log(2 * math.pi)
        return lp

    @staticmethod
    def _uniform(gen, n, lo, hi):
        u = torch.rand(n, generator=gen, dtype=torch.float64, device=gen.device)
        return lo + (hi - lo) * u

    @staticmethod
    def _normal(gen, n):
        return torch.randn(n, generator=gen, dtype=torch.float64,
                           device=gen.device)

    def _prior_column(self, gen, p: SampledParam, n: int):
        if p.dist == 'uniform':
            return self._uniform(gen, n, p.lo, p.hi)
        if p.dist == 'loguniform':
            return torch.exp(self._uniform(gen, n, math.log(p.lo),
                                           math.log(p.hi)))
        if p.dist == 'halfnorm':
            return p.lo + p.hi * torch.abs(self._normal(gen, n))
        return p.lo + p.hi * self._normal(gen, n)

    def sample_prior(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """Draw n points from the prior itself (NOT the ref distribution),
        (n, ndim) on the generator's device. An evidence estimate needs
        exact prior draws; `sample_ref` (narrow start scatter) would bias
        log Z."""
        return torch.stack([self._prior_column(generator, p, n)
                            for p in self.sampled], dim=-1)

    def sample_ref(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """Draw n starting points from the ref distributions (prior
        fallback), clipped into the prior support: (n, ndim) on the
        generator's device."""
        cols = []
        for p in self.sampled:
            if p.ref_dist == 'norm':
                col = p.ref_loc + p.ref_scale * self._normal(generator, n)
            elif p.ref_dist == 'uniform':
                col = self._uniform(generator, n, p.ref_lo, p.ref_hi)
            elif p.ref_dist == 'loguniform':
                col = torch.exp(self._uniform(generator, n, math.log(p.ref_lo),
                                              math.log(p.ref_hi)))
            elif p.ref_dist == 'halfnorm':
                col = p.ref_loc \
                    + p.ref_scale * torch.abs(self._normal(generator, n))
            else:
                col = self._prior_column(generator, p, n)
            if p.dist in ('uniform', 'loguniform'):
                width = p.hi - p.lo
                col = torch.clamp(col, p.lo + 1e-6 * width, p.hi - 1e-6 * width)
            elif p.dist == 'halfnorm':
                col = torch.clamp(col, min=p.lo + 1e-6 * p.hi)
            cols.append(col)
        return torch.stack(cols, dim=-1)

    # ------------------------------------------------------------------
    # unbounded reparameterisation: interval priors (uniform: linear scale;
    # loguniform: log scale) map through a scaled logit, half-line priors
    # (halfnorm) through log, norm priors through identity
    # ------------------------------------------------------------------
    def to_unbounded(self, theta: torch.Tensor) -> torch.Tensor:
        cols = []
        for i, p in enumerate(self.sampled):
            x = theta[..., i]
            if p.dist in ('uniform', 'loguniform'):
                if p.dist == 'loguniform':
                    u = (torch.log(x) - math.log(p.lo)) / math.log(p.hi / p.lo)
                else:
                    u = (x - p.lo) / (p.hi - p.lo)
                # numpy's finfo.epsneg (the largest eps with 1 - eps < 1),
                # which torch.finfo lacks: eps / 2 in IEEE binary formats.
                # A fixed 1e-12 rounds 1 - 1e-12 to 1.0 in f32, and a draw
                # at the support edge would map to logit(1) = +inf
                eps = torch.finfo(u.dtype).eps / 2
                u = torch.clamp(u, eps, 1 - eps)
                cols.append(torch.log(u) - torch.log1p(-u))
            elif p.dist == 'halfnorm':
                # dtype-safe floor: 1e-300 underflows to 0.0 in f32, turning
                # the guard into log(0) = -inf at x == p.lo
                tiny = torch.finfo(x.dtype).tiny
                cols.append(torch.log(torch.clamp(x - p.lo, min=tiny)))
            else:
                cols.append(x)
        return torch.stack(cols, dim=-1)

    def to_bounded(self, y: torch.Tensor) -> torch.Tensor:
        cols = []
        for i, p in enumerate(self.sampled):
            v = y[..., i]
            if p.dist == 'uniform':
                cols.append(p.lo + (p.hi - p.lo) * torch.sigmoid(v))
            elif p.dist == 'loguniform':
                cols.append(torch.exp(math.log(p.lo)
                                      + math.log(p.hi / p.lo) * torch.sigmoid(v)))
            elif p.dist == 'halfnorm':
                cols.append(p.lo + torch.exp(v))
            else:
                cols.append(v)
        return torch.stack(cols, dim=-1)

    def log_jacobian(self, y: torch.Tensor) -> torch.Tensor:
        """log |d theta / d y| summed over parameters."""
        lj = y.new_zeros(y.shape[:-1])
        for i, p in enumerate(self.sampled):
            v = y[..., i]
            if p.dist == 'uniform':
                lj = lj + math.log(p.hi - p.lo) + F.logsigmoid(v) \
                    + F.logsigmoid(-v)
            elif p.dist == 'loguniform':
                # theta = exp(log lo + W sig(v)), W = log(hi/lo):
                # dtheta/dv = theta * W * sig(v) sig(-v)
                s = torch.sigmoid(v)
                lj = lj + math.log(p.lo) + math.log(p.hi / p.lo) * s \
                    + math.log(math.log(p.hi / p.lo)) \
                    + F.logsigmoid(v) + F.logsigmoid(-v)
            elif p.dist == 'halfnorm':
                lj = lj + v
        return lj

    def dtheta_dy_diag(self, y: torch.Tensor) -> torch.Tensor:
        """Per-parameter d theta_i / d y_i at y (..., ndim).

        The reparameterisation is elementwise, so its Jacobian is diagonal;
        this is the factor that maps theta-space proposal widths / covmats
        (cobaya's `proposal:` entries and `.covmat` files) into the
        unbounded space the samplers step in."""
        cols = []
        for i, p in enumerate(self.sampled):
            v = y[..., i]
            if p.dist == 'uniform':
                cols.append((p.hi - p.lo)
                            * torch.sigmoid(v) * torch.sigmoid(-v))
            elif p.dist == 'loguniform':
                theta = torch.exp(math.log(p.lo)
                                  + math.log(p.hi / p.lo) * torch.sigmoid(v))
                cols.append(theta * math.log(p.hi / p.lo)
                            * torch.sigmoid(v) * torch.sigmoid(-v))
            elif p.dist == 'halfnorm':
                cols.append(torch.exp(v))
            else:  # norm: identity map
                cols.append(torch.ones_like(v))
        return torch.stack(cols, dim=-1)

    def proposal_scales_unbounded(self, y: torch.Tensor) -> torch.Tensor:
        """Per-parameter proposal widths mapped to the unbounded space at y
        (..., ndim): sigma_y_i = proposal_i / (d theta_i / d y_i).
        Parameters without a `proposal:` entry keep 1.0. Clipped to
        [1e-3, 20]: near a support edge d theta/d y -> 0 and an unclipped
        seed would blow up the stage-1 warmup before Welford can correct
        it."""
        j = self.dtheta_dy_diag(y)
        prop = torch.tensor([p.proposal if p.proposal else math.nan
                             for p in self.sampled],
                            dtype=y.dtype, device=y.device)
        scales = torch.where(torch.isnan(prop), 1.0,
                             torch.clamp(prop / j, 1e-3, 20.0))
        return scales.expand(y.shape)

    # ------------------------------------------------------------------
    def full_params(self, theta: torch.Tensor) -> Dict:
        """theta (..., ndim) -> params dict of (...) tensors, incl. fixed and
        derived values."""
        shape = theta.shape[:-1]
        params = {k: torch.full(shape, v, dtype=theta.dtype,
                                device=theta.device)
                  for k, v in self.fixed.items()}
        for i, p in enumerate(self.sampled):
            params[p.name] = theta[..., i]
        for d in self.derived:
            params[d.name] = d.fn(*[params[a] for a in d.argnames])
        return params

    def derived_values(self, theta: torch.Tensor) -> Dict:
        params = self.full_params(theta)
        return {d.name: params[d.name] for d in self.derived}
