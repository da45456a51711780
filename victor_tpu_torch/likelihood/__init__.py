from .core import (chi_squared, log_likelihood, multipole_datavector,
                   interpolated_covariance, interpolated_precision)
from .batched import (make_loglike, make_batched_loglike,
                      make_sharded_loglike, chunked_vmap, theta_to_params)
from .multiquantile import (JointBundle, build_joint_tables,
                            joint_log_likelihood, joint_chi_squared,
                            make_batched_joint_loglike)

__all__ = ['chi_squared', 'log_likelihood', 'multipole_datavector',
           'interpolated_covariance', 'interpolated_precision',
           'make_loglike', 'make_batched_loglike', 'make_sharded_loglike',
           'chunked_vmap', 'theta_to_params',
           'JointBundle', 'build_joint_tables', 'joint_log_likelihood',
           'joint_chi_squared', 'make_batched_joint_loglike']
