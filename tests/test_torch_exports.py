"""The port's package-level exports against victor_tpu's, and
`likelihood.chunked_vmap` against its JAX counterpart.

Code written against victor_tpu imports names from the package and its
subpackages (`from victor_tpu.sampling import find_map`); the same import
from victor_tpu_torch must resolve. Each `__all__` of the port holds every
name of victor_tpu's, less the two that exist only for the TPU, and its
extra names are exactly the listed ones, so that a new divergence fails.
"""

import ast
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from victor_tpu.likelihood import chunked_vmap as jax_chunked_vmap
from victor_tpu_torch.likelihood import chunked_vmap

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# subpackage -> names of victor_tpu's __all__ that the port leaves out: the
# Pallas kernel itself, and the TPU's matmul-precision pin (the port's
# counterpart is the TF32 setting, torch.backends.cuda.matmul.allow_tf32)
TPU_ONLY = {'ops': {'ppoly_eval_pallas', 'matmul_highest'}}
# subpackage -> names the port exports beyond victor_tpu's
PORT_ONLY = {
    'io': {'bundle_from_arrays'},
    'likelihood': {'theta_to_params'},
    'ops': {'chebyshev_eval', 'chebyshev_fit', 'dispersion_final',
            'pchip_eval', 'ppoly_eval_multi'},
}
SUBPACKAGES = ['', 'io', 'likelihood', 'likelihoods', 'models', 'ops',
               'parallel', 'sampling', 'utils']


def _module(package, sub):
    return importlib.import_module(f'{package}.{sub}' if sub else package)


def test_every_subpackage_of_victor_tpu_is_listed():
    """SUBPACKAGES names every package directory of victor_tpu, so that a
    new one is compared too."""
    root = os.path.join(REPO, 'victor_tpu')
    found = {d for d in os.listdir(root)
             if os.path.isfile(os.path.join(root, d, '__init__.py'))}
    assert found == set(SUBPACKAGES) - {''}


@pytest.mark.parametrize('sub', SUBPACKAGES)
def test_port_exports_every_name_of_victor_tpu(sub):
    """The port's __all__ holds victor_tpu's less the TPU-only names, and
    every name of it imports."""
    ref = set(_module('victor_tpu', sub).__all__)
    port = _module('victor_tpu_torch', sub)
    missing = ref - TPU_ONLY.get(sub, set()) - set(port.__all__)
    assert not missing, f'victor_tpu_torch.{sub} lacks {sorted(missing)}'
    for name in port.__all__:
        assert getattr(port, name, None) is not None, name


@pytest.mark.parametrize('sub', SUBPACKAGES)
def test_port_extra_exports_are_the_listed_ones(sub):
    """Beyond victor_tpu's names, the port exports exactly PORT_ONLY's; the
    TPU-only names stay out of it."""
    ref = set(_module('victor_tpu', sub).__all__)
    port = set(_module('victor_tpu_torch', sub).__all__)
    assert port - ref == PORT_ONLY.get(sub, set())
    assert not port & TPU_ONLY.get(sub, set())


def _imports_of(path):
    """(module, name) of every `from victor_tpu... import name` in a file,
    at any depth of its code."""
    with open(path) as f:
        tree = ast.parse(f.read())
    return [(node.module, alias.name) for node in ast.walk(tree)
            if isinstance(node, ast.ImportFrom) and node.module and
            node.module.split('.')[0] == 'victor_tpu'
            for alias in node.names]


def test_inference_demo_imports_resolve_from_the_port():
    """examples/inference_demo.py written against victor_tpu: each of its
    imports resolves with victor_tpu_torch in victor_tpu's place."""
    found = _imports_of(os.path.join(REPO, 'examples', 'inference_demo.py'))
    assert ('victor_tpu.sampling', 'find_map') in found
    for module, name in found:
        port = importlib.import_module(
            module.replace('victor_tpu', 'victor_tpu_torch', 1))
        assert hasattr(port, name), f'{module} -> {name}'


def _row_jax(theta):
    """A per-row function: a scalar and a vector of one parameter row."""
    w = jnp.arange(1.0, theta.shape[0] + 1.0)
    return jnp.sum(jnp.sin(theta) * w), theta ** 2 - jnp.cos(theta[0])


def _row_torch(theta):
    w = torch.arange(1.0, theta.shape[0] + 1.0, dtype=theta.dtype)
    return torch.sum(torch.sin(theta) * w), theta ** 2 - torch.cos(theta[0])


@pytest.mark.parametrize('n,chunk,pair', [
    (12, 4, False),         # a batch divisible by the chunk
    (13, 4, False),         # not divisible: the last chunk padded
    (5, 16, False),         # a chunk larger than the batch
    (13, 4, True),          # tuple outputs
])
def test_chunked_vmap_matches_victor_tpu(n, chunk, pair):
    """chunked_vmap of a per-row function equals victor_tpu's, f64, on the
    same rows; the pad rows are dropped."""
    theta = np.random.default_rng(n + chunk).uniform(-2.0, 2.0, (n, 3))
    if pair:
        fj, ft = _row_jax, _row_torch
    else:
        def fj(t):
            return _row_jax(t)[0]

        def ft(t):
            return _row_torch(t)[0]
    want = jax.tree_util.tree_map(
        np.asarray, jax_chunked_vmap(fj, chunk)(jnp.asarray(theta)))
    got = chunked_vmap(ft, chunk)(torch.as_tensor(theta, dtype=torch.float64))
    if pair:
        assert isinstance(got, tuple) and len(got) == 2
    else:
        want, got = (want,), (got,)
    for w, g in zip(want, got):
        assert g.shape == w.shape and g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-14, atol=1e-14)
