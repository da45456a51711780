"""The benchmark's plain reference for victor_tpu_torch's likelihood and
samplers.

`streaming.py` holds the Gaussian streaming model of the BOSS DR12
void-galaxy fit and its Sellentin likelihood, written from the model's
equations in plain NumPy, SciPy and PyTorch, in both streaming modes that
the configurations state (exact, and the fast mode's Chebyshev
interpolants). It reads the raw data files itself, shares no code, table or
operator with the program and imports nothing of it; autograd
differentiates it directly.

`samplers.py` holds one SMC stage and one HMC step, which the check replays
from the program's recorded state.

Entry points:

    model = build(config, device, dtype)
    lnl, chi2 = loglike(model, config, 'smc', theta)          # (N,), (N,)
    lnp, chi2, grad = logpost_and_grad(model, config, 'hmc', space, y)
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from .streaming import Model

#: rows per reference call: a block of this many parameter points at a time
BLOCK = 64


def build(config: Dict, device, dtype=torch.float64) -> Model:
    """The configuration's model, built from its raw files, on `device` as
    `dtype`."""
    return Model(config, device, dtype)


class UniformSpace:
    """The sampled parameters of a cobaya-style params block with uniform
    priors, and the logistic map between the unbounded sampling space y and
    the physical space theta = lo + (hi - lo) * sigmoid(y)."""

    def __init__(self, params_block: Dict):
        self.names, lo, hi = [], [], []
        for name, spec in params_block.items():
            prior = spec['prior']
            if prior.get('dist', 'uniform') != 'uniform':
                raise ValueError(f'{name}: the reference knows uniform '
                                 f'priors only, not {prior["dist"]!r}')
            self.names.append(name)
            lo.append(float(prior['min']))
            hi.append(float(prior['max']))
        self.lo, self.hi = lo, hi

    def to_bounded(self, y: torch.Tensor) -> torch.Tensor:
        return torch.stack([lo + (hi - lo) * torch.sigmoid(y[:, i])
                            for i, (lo, hi) in enumerate(zip(self.lo,
                                                             self.hi))], -1)

    def log_prior_y(self, y: torch.Tensor) -> torch.Tensor:
        """log prior(theta(y)) + log |d theta / d y|, (N,)."""
        theta = self.to_bounded(y)
        out = y.new_zeros(y.shape[0])
        for i, (lo, hi) in enumerate(zip(self.lo, self.hi)):
            x, v = theta[:, i], y[:, i]
            inside = (x >= lo) & (x <= hi)
            out = torch.where(inside, out - math.log(hi - lo), -math.inf)
            out = out + math.log(hi - lo) \
                + torch.nn.functional.logsigmoid(v) \
                + torch.nn.functional.logsigmoid(-v)
        return out


def _params(names, theta: torch.Tensor) -> Dict:
    return {n: theta[:, i] for i, n in enumerate(names)}


def loglike(model: Model, config: Dict, path: str, theta: torch.Tensor,
            block: int = BLOCK) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lnL, chi2) at the physical points theta (N, ndim), in blocks of
    `block` rows, in the modes the configuration states for `path`."""
    names, modes = list(config['params']), config['modes'][path]
    outs = []
    with torch.no_grad():
        for t in torch.split(theta.to(model.device, model.dtype), block):
            outs.append(model.loglike(_params(names, t), modes))
    return tuple(torch.cat(o) for o in zip(*outs))


def loglike_y(model: Model, config: Dict, path: str, space: UniformSpace,
              y: torch.Tensor, block: int = BLOCK):
    """(lnL, chi2) at the unbounded points y (N, ndim), a non-finite lnL
    as -inf."""
    lnl, chi2 = loglike(model, config, path, space.to_bounded(y), block)
    return torch.where(torch.isfinite(lnl), lnl, -math.inf), chi2


def logpost_and_grad(model: Model, config: Dict, path: str,
                     space: UniformSpace, y: torch.Tensor, block: int = BLOCK):
    """(log posterior over y (N,), chi2 (N,), its gradient (N, ndim)): the
    chains' target, lnL + log prior + log Jacobian, a non-finite total as
    -inf; autograd through the plain model, block by block."""
    names, modes = list(config['params']), config['modes'][path]
    lnps, chi2s, grads = [], [], []
    for yb in torch.split(y.to(model.device, model.dtype), block):
        with torch.enable_grad():
            yb = yb.detach().requires_grad_()
            lnl, chi2 = model.loglike(_params(names, space.to_bounded(yb)),
                                      modes)
            lnp = lnl + space.log_prior_y(yb)
            lnp = torch.where(torch.isfinite(lnp), lnp, -math.inf)
            (g,) = torch.autograd.grad(lnp.sum(), yb)
        lnps.append(lnp.detach())
        chi2s.append(chi2.detach())
        grads.append(g)
    return torch.cat(lnps), torch.cat(chi2s), torch.cat(grads)
