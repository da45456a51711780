"""victor_tpu_torch: the PyTorch / CUDA port of victor_tpu.

The same void-galaxy cross-correlation theory and likelihood as the JAX
package `victor_tpu`, which stays the reference it is tested against. Module
names mirror the JAX package. Parameters are dicts of `(B,)` tensors and every
intermediate carries that batch axis first, in place of `jax.vmap`. Tables
are dataclasses of tensors built once on the host and moved to a device.
The class surface (`CCFModel`, `CCFFit`, `BackgroundCosmology`,
`ExcursionSetProfile`) takes numpy in and gives numpy out, one parameter
point per call.

On CPU tensors every kernel runs its plain PyTorch version; on CUDA tensors
it runs the hand-written kernel under `kernels/` (built with nvcc at first
use) or raises. This package never imports jax.
"""

from ._version import __version__
from .errors import InputError
from .models.cosmology import BackgroundCosmology
from .api import CCFModel, CCFFit
from .models.esm import ExcursionSetProfile
from . import plottools, utils

__all__ = ['__version__', 'InputError', 'BackgroundCosmology',
           'CCFModel', 'CCFFit', 'ExcursionSetProfile', 'plottools', 'utils']
