"""cobaya Likelihood adapter (reference surface:
victor/likelihoods/CCFLikelihood.py:6-42), the port of
`victor_tpu/likelihoods/CCFLikelihood.py`.

Kept for ecosystem compatibility: existing cobaya YAML configs pointing at
`victor.likelihoods.CCFLikelihood` can switch the class path to
`victor_tpu_torch.likelihoods.CCFLikelihood` and run unchanged; the class
defaults add `device` (default `cuda`), where CCFFit builds its tables. The
preferred, far faster path is the package's own sampler
(`python -m victor_tpu_torch run`), which consumes the same params block.

The derived-fsigma8 branch implements the reference's *intent*: it fires for
`matter_ccf.model == 'excursion_set'` (the reference compares against the
string 'use_excursion_model' and so never fires; SURVEY.md bug 4).
"""

from __future__ import annotations

import os

import numpy as np

# the cobaya version whose Likelihood contract the adapter (and its
# interface double, tests/test_torch_cobaya_adapter.py) is frozen against:
# initialize / get_can_provide_params / get_requirements / calculate(state,
# want_derived, **params) / current_derived, per the cobaya-3.5 docs
_PINNED_COBAYA = '3.5'
_HAVE_COBAYA = False

try:
    from cobaya.likelihood import Likelihood as _CobayaLikelihood
    _HAVE_COBAYA = True
except ImportError:          # cobaya optional: stub keeps the import valid
    _CobayaLikelihood = object

if _HAVE_COBAYA:
    # contract-drift canary: this adapter has only been exercised against
    # the documented cobaya-3.5 interface, through a frozen double. If an
    # environment DOES have cobaya, a major/minor version drift must be
    # loud, not a silent behavioural mismatch inside the sampler loop.
    try:
        from cobaya import __version__ as _cobaya_version
    except ImportError:
        _cobaya_version = '0'
    if _cobaya_version.split('.')[:2] != _PINNED_COBAYA.split('.')[:2]:
        import warnings
        warnings.warn(
            f'victor_tpu_torch.likelihoods.CCFLikelihood is frozen against '
            f'the cobaya-{_PINNED_COBAYA} Likelihood contract but cobaya '
            f'{_cobaya_version} is installed; the adapter has not been '
            f'validated against this version — verify initialize/calculate '
            f'semantics before trusting chains', stacklevel=2)


class CCFLikelihood(_CobayaLikelihood):
    """Wraps CCFFit.log_likelihood for cobaya's MCMC driver."""

    model: dict = None
    data: dict = None
    config_file: str = None
    device: str = 'cuda'

    def initialize(self):
        if not _HAVE_COBAYA:
            raise ImportError('cobaya is not installed; use '
                              'python -m victor_tpu_torch run instead')
        import yaml

        from ..api import CCFFit

        if self.model and self.data:
            model, data = self.model, self.data
        else:
            if not self.config_file or not os.path.isfile(self.config_file):
                raise FileNotFoundError(
                    f'CCFLikelihood: config_file {self.config_file!r} not found')
            with open(self.config_file) as f:
                cfg = yaml.safe_load(f)
            model, data = cfg['model'], cfg['data']
        self.ccf_fit = CCFFit(model, data, device=self.device)

    def get_can_provide_params(self):
        # advertise fsigma8 only when calculate() actually provides it
        # (ESM runs): claiming it unconditionally passes cobaya's dependency
        # resolution and then fails at the first sampled point for
        # template/linear_bias configs
        if self.ccf_fit.bundle.theory_opts.matter_model == 'excursion_set':
            return ['chi2_ccf_correct', 'fsigma8']
        return ['chi2_ccf_correct']

    def calculate(self, state, want_derived=True, **params_values):
        lnlike, chisq = self.ccf_fit.log_likelihood(params_values)
        state['logp'] = lnlike
        derived = {'chi2_ccf_correct': chisq}
        if want_derived and \
                self.ccf_fit.bundle.theory_opts.matter_model == 'excursion_set':
            # skipped when cobaya does not want derived values: esm_s8z is
            # a cosmology-state computation and a host read per call
            from ..models.esm import esm_s8z
            fit = self.ccf_fit
            s8z = float(esm_s8z(fit.bundle.tables, fit.bundle.spec,
                                fit._tp({k: v for k, v in params_values.items()
                                         if np.isscalar(v)}))[0])
            derived['fsigma8'] = params_values.get('f', 0.0) * s8z
        state['derived'] = derived
