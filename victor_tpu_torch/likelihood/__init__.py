from .core import (chi_squared, log_likelihood, multipole_datavector,
                   interpolated_covariance, interpolated_precision)
from .batched import make_loglike, make_batched_loglike, theta_to_params

__all__ = ['chi_squared', 'log_likelihood', 'multipole_datavector',
           'interpolated_covariance', 'interpolated_precision',
           'make_loglike', 'make_batched_loglike', 'theta_to_params']
