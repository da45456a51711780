"""victor_tpu_torch: the PyTorch / CUDA port of victor_tpu.

The same void-galaxy cross-correlation theory and likelihood as the JAX
package `victor_tpu`, which stays the reference it is tested against. Module
names mirror the JAX package. Parameters are dicts of `(B,)` tensors and every
intermediate carries that batch axis first, in place of `jax.vmap`. Tables
are dataclasses of tensors built once on the host and moved to a device.

On CPU tensors every kernel runs its plain PyTorch version; on CUDA tensors
it runs the hand-written kernel under `kernels/` (built with nvcc at first
use) or raises. This package never imports jax.
"""

from ._version import __version__
from .errors import InputError

__all__ = ['__version__', 'InputError']
