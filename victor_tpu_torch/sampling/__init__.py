from .priors import ParamSpace, SampledParam, DerivedParam
from .ensemble import EnsembleState, init_state, step, run, make_logpost
from .runner import run_mcmc, run_hmc_mcmc, make_posterior, MCMCResult
from .optimize import (find_map, MAPResult, profile_scan, ProfileResult,
                       fisher_forecast, FisherResult,
                       parametric_bootstrap, BootstrapResult)
from .smc import run_smc, SMCResult
from .nested import run_nested, NestedResult
from .post import reweight, PostResult
from .tension import run_tension, parameter_shift, TensionResult
from .targets import ProductTarget
from . import hmc
from . import mh
from . import nuts
from .chains import (save_checkpoint, load_checkpoint, export_getdist,
                     read_getdist, read_covmat, save_hmc_checkpoint,
                     load_hmc_checkpoint)
from .diagnostics import (split_rhat, effective_sample_size, autocorr_time,
                          acceptance_fraction)
from .gof import chi2_tail_probability, posterior_predictive_pvalue

__all__ = [
    'ParamSpace', 'SampledParam', 'DerivedParam',
    'EnsembleState', 'init_state', 'step', 'run', 'make_logpost',
    'run_mcmc', 'run_hmc_mcmc', 'make_posterior', 'MCMCResult', 'hmc', 'mh',
    'nuts',
    'find_map', 'MAPResult', 'profile_scan', 'ProfileResult',
    'fisher_forecast', 'FisherResult',
    'parametric_bootstrap', 'BootstrapResult', 'run_smc', 'SMCResult',
    'run_nested', 'NestedResult',
    'reweight', 'PostResult',
    'run_tension', 'parameter_shift', 'TensionResult', 'ProductTarget',
    'save_checkpoint', 'load_checkpoint', 'export_getdist',
    'read_getdist', 'read_covmat', 'save_hmc_checkpoint',
    'load_hmc_checkpoint',
    'split_rhat', 'effective_sample_size', 'autocorr_time',
    'acceptance_fraction',
    'chi2_tail_probability', 'posterior_predictive_pvalue',
]
