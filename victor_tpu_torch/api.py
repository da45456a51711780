"""Class-based API with the reference victor surface (CCFModel / CCFFit).

The port of `victor_tpu/api.py`. A user of the reference package (or of
victor_tpu) constructs these with the same `model:` / `data:` config dicts
and calls the same methods with the same signatures (victor/ccf_model.py:24,
victor/ccf_fit.py:10); the constructors add keyword-only `device` (the card
unless 'cpu' is asked for) and `dtype`. Each call turns the parameter dict
into (1,) tensors on the bundle's device and runs the functional core
(`models.ccf_theory`, `likelihood.core`), so the exact spline lookups run
`ppoly_eval.cu` on the card and `dispersion_final='fused'` runs
`dispersion_final.cu`. The same object hands out its `bundle` for batched
and sampled use.

Inputs and outputs are numpy (host) for notebook ergonomics; per-call option
overrides accept the reference kwarg vocabulary. There is no jit cache: the
one per-instance memo is the multipole projection matrix with its mu grid.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .config import FitOptions, TheoryOptions
from .errors import InputError
from .io.tables import CCFModelBundle, build_tables
from .likelihood import core as _lk
from .models import ccf_theory as _th
from . import ops

_THEORY_KEYS = set(TheoryOptions.__dataclass_fields__)
_FIT_KEYS = set(FitOptions.__dataclass_fields__)


def _split_kwargs(kwargs):
    opts_kw = {k: v for k, v in kwargs.items() if k in _THEORY_KEYS}
    fit_kw = {k: v for k, v in kwargs.items() if k in _FIT_KEYS}
    unknown = set(kwargs) - _THEORY_KEYS - _FIT_KEYS
    if unknown:
        raise InputError(f'Unrecognised option override(s): {sorted(unknown)}')
    return opts_kw, fit_kw


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _row(t: torch.Tensor) -> torch.Tensor:
    """The single batch row of a (1, ...) result; a batch-free table (the
    template's profiles) as it is."""
    return t[0] if t.ndim == 2 else t


class Interp2D:
    """Callable 2D interpolator with the old scipy.interp2d convention the
    reference returns from theory_xi_2D (victor/ccf_model.py:893): f(x, y)
    evaluates on the tensor grid and returns shape (len(y), len(x)).

    Default kind='linear' because that is scipy.interp2d's default and what
    the reference's bare `si.interp2d(sperp, spar, xi)` calls use
    (ccf_model.py:893,933): node values are interpolation-free either way,
    but off-node queries must match the reference surface."""

    def __init__(self, x, y, z_yx, kind: str = 'linear'):
        from scipy.interpolate import RectBivariateSpline
        k = 3 if kind == 'cubic' else 1
        self._spl = RectBivariateSpline(np.asarray(x), np.asarray(y),
                                        np.asarray(z_yx).T, kx=k, ky=k, s=0)

    def __call__(self, x, y):
        x = np.atleast_1d(np.asarray(x, dtype=float))
        y = np.atleast_1d(np.asarray(y, dtype=float))
        return self._spl(x, y).T


class CCFModel:
    """Theory engine with the reference class surface (victor/ccf_model.py:24)."""

    def __init__(self, model: Dict, _bundle: Optional[CCFModelBundle] = None,
                 *, device='cuda', dtype: torch.dtype = torch.float64):
        # _bundle: adopt an already-built table set (its device and dtype)
        # instead of re-running the host-side ingestion
        self.model_config = model
        self.bundle = _bundle if _bundle is not None else build_tables(
            model, None, device=device, dtype=dtype)
        t = self.bundle.tables
        self.device, self.dtype = t.r.device, t.r.dtype
        self.r = _host(t.r)
        self.z_eff = float(t.z_eff)
        self.iaH = float(t.iaH)
        self.poles_r = list(self.bundle.spec.poles_r)
        self.fixed_real_input = self.bundle.spec.fixed_real_input

    def _tensor(self, v) -> torch.Tensor:
        if not isinstance(v, torch.Tensor):
            v = np.array(v, dtype=np.float64)       # a writable copy
        return torch.as_tensor(v, dtype=self.dtype, device=self.device)

    def _tp(self, params: Dict) -> Dict:
        """The numbers of `params` as (1,) tensors on the bundle's device;
        `label`, `options`, `plot_kwargs` and other str/dict/list values
        are dropped."""
        return {k: self._tensor(v).reshape(1) for k, v in params.items()
                if not isinstance(v, (str, dict, list))}

    def _beta(self, beta) -> torch.Tensor:
        return self._tensor(0.0 if beta is None else beta).reshape(1)

    def _proj_matrix(self, poles: tuple):
        """Projection matrix (f64) + the mu grid xi must be evaluated on,
        memoised on the instance (a class-level cache would keep dropped
        instances and their device tables alive).

        Even poles project over mu in [0, 1] with factor 2l+1; any odd pole
        switches ALL requested poles to the full mu in [-1, 1] grid with
        factor (2l+1)/2, exactly as the reference does
        (victor/ccf_model.py:816-823): projecting an odd P_ell against a
        [0, 1] evaluation would return the spurious nonzero half-integral
        instead of the ~0 a mu-even xi gives."""
        memo = self.__dict__.setdefault('_proj', {})
        if poles not in memo:
            odd = any(ell % 2 for ell in poles)
            mu_grid = self.bundle.tables.mu_grid
            mu = np.linspace(-1.0, 1.0, mu_grid.shape[0]) if odd \
                else _host(mu_grid).astype(np.float64)
            proj = ops.multipole_projection_matrix(mu, list(poles), npts=200,
                                                   even=not odd)
            memo[poles] = (torch.as_tensor(proj, device=self.device),
                           self._tensor(mu))
        return memo[poles]

    def _opts(self, kwargs) -> TheoryOptions:
        opts_kw, _ = _split_kwargs(kwargs)
        return self.bundle.theory_opts.replace(**opts_kw)

    # ------------------------------------------------------------------
    # reference API
    # ------------------------------------------------------------------
    def get_interpolated_real_multipoles(self, beta=None) -> np.ndarray:
        """(n_ell, n_r) real-space multipoles at beta (victor/ccf_model.py:299)."""
        t, spec = self.bundle.tables, self.bundle.spec
        if beta is None and not spec.fixed_real_input:
            raise InputError('Need to supply a valid value of beta for interpolation')
        return np.atleast_2d(_host(_th.real_multipoles(t, spec,
                                                       self._beta(beta))[0]))

    def _profile_spline(self, r, values):
        """Node values at the r_v knots, interpolated to `r` with the ext=3
        cubic spline the reference uses downstream (exact at the knots)."""
        from scipy.interpolate import InterpolatedUnivariateSpline as IUS
        r_v = _host(self.bundle.tables.r_v)
        r = np.atleast_1d(np.asarray(r, dtype=float))
        return tuple(IUS(r_v, _host(_row(v)), k=3, ext=3)(r) for v in values)

    def delta_profiles(self, r, params: Dict, **kwargs):
        """(delta(r), Delta(r)) (victor/ccf_model.py:328-383)."""
        d_rv, D_rv, _, _ = _th.delta_profiles(
            self.bundle.tables, self.bundle.spec, self._opts(kwargs),
            self._tp(params))
        return self._profile_spline(r, (d_rv, D_rv))

    def velocity_terms(self, r, params: Dict, **kwargs):
        """(v_r(r), dv_r/dr(r)) (victor/ccf_model.py:385-492); exact at the
        r_v knots, spline-interpolated elsewhere."""
        vr, dvr = _th.velocity_terms(self.bundle.tables, self.bundle.spec,
                                     self._opts(kwargs), self._tp(params))
        return self._profile_spline(r, (vr, dvr))

    def theory_xi(self, s, mu, params: Dict, **kwargs):
        """xi^s at paired (s, mu) points of any matching shape
        (victor/ccf_model.py:538; the reference's rectangular-grid rebuild
        via np.unique, its bug 5, is replaced by true pointwise support)."""
        opts = self._opts(kwargs)
        s_arr = np.atleast_1d(np.asarray(s, dtype=float))
        mu_arr = np.atleast_1d(np.asarray(mu, dtype=float))
        s_b, mu_b = np.broadcast_arrays(s_arr, mu_arr)
        out = _th.theory_xi_points(self.bundle.tables, self.bundle.spec, opts,
                                   self._tp(params), self._tensor(s_b.ravel()),
                                   self._tensor(mu_b.ravel()))
        out = _host(out[0]).reshape(s_b.shape)
        return float(out[0]) if np.ndim(s) == 0 and np.ndim(mu) == 0 else out

    def theory_multipoles(self, s, params: Dict, poles=(0, 2), **kwargs):
        """Multipoles of the theory xi at radial bins `s`: dict keyed '0','2',...
        (victor/ccf_model.py:791-827). The projection is an f64 matmul
        (no TF32)."""
        opts = self._opts(kwargs)
        poles = tuple(np.atleast_1d(poles).tolist())
        proj, mu_grid = self._proj_matrix(poles)
        s_t = self._tensor(np.atleast_1d(np.asarray(s, dtype=float)))
        xi = _th.theory_xi_grid(self.bundle.tables, self.bundle.spec, opts,
                                self._tp(params), s=s_t, mu=mu_grid)[0]
        mult = _host(torch.matmul(proj, xi.to(torch.float64)))
        return {f'{ell}': mult[i] for i, ell in enumerate(poles)}

    def theory_multipole_vector(self, s, params: Dict, poles=(0, 2), **kwargs):
        """Stacked multipole vector (victor/ccf_model.py:829-860)."""
        m = self.theory_multipoles(s, params, poles=poles, **kwargs)
        return np.concatenate([m[f'{ell}'] for ell in np.atleast_1d(poles)])

    def theory_xi_2D(self, params: Dict, rmax: float = 85, **kwargs) -> Interp2D:
        """2D xi^s(s_perp, s_par) interpolator (victor/ccf_model.py:862-894),
        computed in one call instead of the reference's pointwise double
        loop."""
        sperp = np.linspace(0.01, rmax)
        spar = np.linspace(-rmax, rmax)
        PP, LL = np.meshgrid(sperp, spar)
        ss = np.sqrt(PP ** 2 + LL ** 2)
        mm = LL / ss
        xi = self.theory_xi(ss, mm, params, **kwargs)
        return Interp2D(sperp, spar, xi)

    def xi_2D_from_multipoles(self, params: Dict, rmax: float = 85, **kwargs) -> Interp2D:
        """2D ccf reconstructed from ell=0,2,4 multipoles
        (victor/ccf_model.py:896-934)."""
        from scipy.interpolate import InterpolatedUnivariateSpline as IUS
        s = np.linspace(0.01, rmax)
        mult = self.theory_multipoles(s, params, poles=(0, 2, 4), **kwargs)
        splines = {ell: IUS(s, mult[f'{ell}'], k=3) for ell in (0, 2, 4)}
        sperp = np.linspace(0.01, rmax)
        spar = np.linspace(-rmax, rmax)
        PP, LL = np.meshgrid(sperp, spar)
        ss = np.sqrt(PP ** 2 + LL ** 2)
        mm = LL / ss
        grid = np.zeros_like(ss)
        for ell in (0, 2, 4):
            grid += splines[ell](ss) * ops.legendre_p(ell, mm)
        return Interp2D(sperp, spar, grid)

    # ------------------------------------------------------------------
    # plotting (host-side matplotlib; victor/ccf_model.py:936-1041)
    # ------------------------------------------------------------------
    def plot_model_multipoles(self, *parameters, s=None, ell=2, diff=False,
                              ax=None, **kwargs):
        import matplotlib.pyplot as plt
        ax = ax or plt.gca()
        if s is None:
            s = self.r
        for params in parameters:
            options = params.get('options', {})
            label = params.get('label', None)
            plot_kwargs = params.get('plot_kwargs', {})
            theory = self.theory_multipoles(s, params, poles=ell, **options)[f'{ell}']
            ind = [0, 2, 4].index(ell)
            if diff:
                refth = np.interp(s, self.r, self.get_interpolated_real_multipoles(
                    params.get('beta', None))[ind])
            else:
                refth = np.zeros_like(theory)
            ax.plot(s, theory - refth, label=label, **plot_kwargs)
        ax.set_xlabel(kwargs.get('xlabel', r'$s\;[h^{-1}\mathrm{Mpc}]$'))
        ax.set_ylabel(kwargs.get('ylabel', ''))
        return ax

    def plot_realspace_multipoles(self, *parameters, r=None, ell=2, ax=None,
                                  **kwargs):
        import matplotlib.pyplot as plt
        ax = ax or plt.gca()
        if self.fixed_real_input and len(parameters) == 0:
            parameters = [{}]
        if r is None:
            r = self.r
        ind = [0, 2, 4].index(ell)
        for params in parameters:
            mult = np.interp(r, self.r, self.get_interpolated_real_multipoles(
                params.get('beta', None))[ind])
            ax.plot(r, mult, label=params.get('label', None),
                    **params.get('plot_kwargs', {}))
        ax.set_xlabel(kwargs.get('xlabel', r'$s\;[h^{-1}\mathrm{Mpc}]$'))
        ax.set_ylabel(kwargs.get('ylabel', ''))
        return ax


class CCFFit(CCFModel):
    """Likelihood layer with the reference class surface (victor/ccf_fit.py:10)."""

    def __init__(self, model: Dict, data: Dict,
                 _bundle: Optional[CCFModelBundle] = None, *, device='cuda',
                 dtype: torch.dtype = torch.float64):
        # _bundle: adopt an already-built table set instead of re-running
        # the host-side ingestion (the CLI's analyze figure holds one)
        bundle = _bundle if _bundle is not None else build_tables(
            model, data, device=device, dtype=dtype)
        super().__init__(model, _bundle=bundle)
        self.data_config = data
        self.s = _host(bundle.tables.s)
        self.poles_s = list(bundle.spec.poles_s)
        self.fixed_data = bundle.spec.fixed_data

    # ------------------------------------------------------------------
    def get_interpolated_redshift_multipoles(self, beta=None) -> np.ndarray:
        return np.atleast_2d(self.multipole_datavector(beta).reshape(
            len(self.poles_s), len(self.s)))

    def multipole_datavector(self, beta=None) -> np.ndarray:
        t, spec = self.bundle.tables, self.bundle.spec
        if beta is None and not spec.fixed_data:
            raise InputError('Need to supply a valid value of beta for interpolation')
        return _host(_lk.multipole_datavector(t, spec, self._beta(beta))[0])

    def get_interpolated_covariance(self, beta=None) -> np.ndarray:
        t, spec = self.bundle.tables, self.bundle.spec
        if beta is None and not spec.fixed_covmat:
            # reference ccf_fit.py:213-214; beta=0.0 would silently clamp
            # to the boundary covmat, giving wrong errors/correlations
            raise InputError('Need to supply a valid value of beta for interpolation')
        return _host(_lk.interpolated_covariance(t, spec, self._beta(beta))[0])

    def get_interpolated_precision(self, beta=None) -> np.ndarray:
        t, spec = self.bundle.tables, self.bundle.spec
        if beta is None and not spec.fixed_covmat:
            raise InputError('Need to supply a valid value of beta for interpolation')
        return _host(_lk.interpolated_precision(t, spec, self._beta(beta))[0])

    def correlation_matrix(self, beta=None) -> np.ndarray:
        """Normalised correlation matrix (victor/ccf_fit.py:262-284)."""
        cov = self.get_interpolated_covariance(beta)
        d = np.sqrt(np.diag(cov))
        return cov / np.outer(d, d)

    def diagonal_errors(self, beta=None) -> np.ndarray:
        """Per-bin errors from the covariance diagonal
        (victor/ccf_fit.py:286-304)."""
        cov = self.get_interpolated_covariance(beta)
        return np.sqrt(np.diag(cov)).reshape(len(self.poles_s), len(self.s))

    def chi_squared(self, params: Dict, **kwargs):
        """(chi2, covariance) (victor/ccf_fit.py:325-354)."""
        chisq, cov = _lk.chi_squared(self.bundle.tables, self.bundle.spec,
                                     self._opts(kwargs), self._tp(params))
        if cov is None:
            # explicit beta_covariance='factored' override: the factored
            # path never forms the blended covariance; rebuild it here
            # since this API promises to return it
            return float(chisq[0]), self.get_interpolated_covariance(
                params.get('beta') if not self.bundle.spec.fixed_covmat
                else None)
        return float(chisq[0]), _host(cov[0])

    def log_likelihood(self, params: Dict, **kwargs):
        """(lnlike, chi2) (victor/ccf_fit.py:356-483)."""
        opts_kw, fit_kw = _split_kwargs(kwargs)
        lnl, chisq = _lk.log_likelihood(
            self.bundle.tables, self.bundle.spec,
            self.bundle.theory_opts.replace(**opts_kw),
            self.bundle.fit_opts.replace(**fit_kw), self._tp(params))
        return float(lnl[0]), float(chisq[0])

    # ------------------------------------------------------------------
    def plot_multipole_comparison(self, *parameters, s=None, ell=2, diff=False,
                                  ax=None, **kwargs):
        """Data points with errors vs theory curves (victor/ccf_fit.py:485-584)."""
        import matplotlib.pyplot as plt
        ax = ax or plt.gca()
        if s is None:
            s = self.s
        ind = [0, 2, 4].index(ell)
        calculate_chi2 = kwargs.get('chi2', False)

        betas_plotted = set()
        for params in parameters:
            options = params.get('options', {})
            label = params.get('label', None)
            plot_kwargs = params.get('plot_kwargs', {})
            if calculate_chi2:
                chi2, _ = self.chi_squared(params, **options)
                label = (label + ' ' if label else '') + f'$\\chi^2={chi2:.2f}$'
            theory = self.theory_multipoles(s, params, poles=ell, **options)[f'{ell}']
            if diff:
                refth = np.interp(s, self.r, self.get_interpolated_real_multipoles(
                    params.get('beta', None))[ind])
            else:
                refth = np.zeros_like(theory)
            line = ax.plot(s, theory - refth, label=label, **plot_kwargs)

            beta_key = None if self.fixed_data else float(params['beta'])
            if beta_key not in betas_plotted:
                betas_plotted.add(beta_key)
                datam = self.get_interpolated_redshift_multipoles(
                    params.get('beta', None))[ind]
                errors = self.diagonal_errors(params.get('beta', None))[ind]
                if diff:
                    refd = np.interp(self.s, self.r,
                                     self.get_interpolated_real_multipoles(
                                         params.get('beta', None))[ind])
                else:
                    refd = np.zeros_like(datam)
                ax.errorbar(self.s, datam - refd, yerr=errors, fmt='o',
                            color=line[0].get_color(), markersize=4, capsize=2)
        ax.set_xlabel(kwargs.get('xlabel', r'$s\;[h^{-1}\mathrm{Mpc}]$'))
        ax.set_ylabel(kwargs.get('ylabel', ''))
        return ax
