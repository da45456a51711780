"""The port's BackgroundCosmology and EisensteinHu classes, and the host
quadrature builders of `victor_tpu_torch.ops`, against victor_tpu's.

Every BackgroundCosmology method, flat and with Omega_K = +-0.05, at a
scalar and at an array of redshifts, within 1e-12 relative; tensor inputs
stay tensors and differentiate under autograd like victor_tpu's under
jax.grad. These are the checks that tests/test_cosmology.py makes against
the upstream victor where it is installed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from victor_tpu import ops as jops
from victor_tpu.models.cosmology import BackgroundCosmology as JCosmo
from victor_tpu.models.eisenstein_hu import EisensteinHu as JEH
from victor_tpu_torch import ops as tops
from victor_tpu_torch.models.cosmology import BackgroundCosmology as TCosmo
from victor_tpu_torch.models.eisenstein_hu import EisensteinHu as TEH

torch.set_num_threads(1)

RTOL = 1e-12
COSMOLOGIES = {
    'flat': {'Omega_m': 0.31},
    'open': {'Omega_m': 0.3, 'Omega_K': 0.05, 'H0': 70.0},
    'closed': {'Omega_m': 0.32, 'Omega_K': -0.05, 'h': 0.68,
               'sound_horizon': 147.0, 'sigma8': 0.8},
}
Z_ARRAY = np.array([0.05, 0.38, 0.57, 1.0, 2.3, 5.0])
# (method, extra keyword arguments)
METHODS = [
    ('Ez', {}), ('H', {}), ('Om', {}),
    ('comoving_distance', {}), ('comoving_distance', {'mpc_units': True}),
    ('comoving_transverse_distance', {}),
    ('comoving_transverse_distance', {'mpc_units': True}),
    ('hubble_distance', {}), ('hubble_distance', {'mpc_units': True}),
    ('angular_diameter_distance', {}),
    ('angular_diameter_distance', {'mpc_units': True}),
    ('F_AP', {}), ('y', {}),
    ('DH_over_rd', {}), ('DM_over_rd', {'rd': 150.0}),
    ('DV_over_rd', {}), ('DV_over_rd', {'mpc_units': True}),
    ('DA_over_rd', {}), ('Hz_rd', {}), ('Hz_rd', {'h_units': False}),
    ('growth_factor', {}), ('growth_rate', {}), ('growth_rate', {'gamma': 0.55}),
    ('sigma8z', {}), ('sigma8z', {'sigma80': 0.75}), ('fsigma8', {}),
]


def _id(m):
    name, kw = m
    return name + ''.join(f',{k}={v}' for k, v in kw.items())


@pytest.mark.parametrize('cosmo', COSMOLOGIES)
@pytest.mark.parametrize('method', METHODS, ids=_id)
def test_method_vs_jax(cosmo, method):
    """A scalar z gives a float, an array an ndarray, as victor_tpu's."""
    name, kw = method
    t, j = TCosmo(COSMOLOGIES[cosmo]), JCosmo(COSMOLOGIES[cosmo])
    for z in (0.57, Z_ARRAY):
        got = getattr(t, name)(z, **kw)
        want = getattr(j, name)(z, **kw)
        assert type(got) is type(want) or (
            np.ndim(got) == np.ndim(want) == 0), (type(got), type(want))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def test_dv_over_rd_is_the_intended_formula():
    """D_V = (z D_M^2 D_H)^(1/3) / r_d, not the reference's bug 8."""
    c = TCosmo({'Omega_m': 0.31})
    z = 0.57
    dv = (z * c.comoving_transverse_distance(z) ** 2 *
          c.hubble_distance(z)) ** (1 / 3)
    assert c.DV_over_rd(z) == pytest.approx(dv / c.rd, rel=1e-14)
    # in Mpc, BOSS CMASS's D_V / r_d at z = 0.57 is about 13.7; the
    # reference's z * D_M^2 * D_H^(1/3) / r_d is about 10^4
    assert 13 < c.DV_over_rd(z, mpc_units=True) < 15


@pytest.mark.parametrize('cosmo', COSMOLOGIES)
@pytest.mark.parametrize('name', [
    'Ez', 'H', 'Om', 'comoving_distance', 'comoving_transverse_distance',
    'hubble_distance', 'angular_diameter_distance', 'F_AP', 'DV_over_rd',
    'Hz_rd', 'growth_factor', 'growth_rate', 'sigma8z', 'fsigma8'])
def test_tensor_input_stays_a_tensor(cosmo, name):
    """A tensor z comes back as a tensor on its device with the numpy
    method's values."""
    c = TCosmo(COSMOLOGIES[cosmo])
    zt = torch.as_tensor(Z_ARRAY)
    got = getattr(c, name)(zt)
    assert isinstance(got, torch.Tensor) and got.device == zt.device
    assert got.dtype == torch.float64 and got.shape == zt.shape
    np.testing.assert_allclose(got.numpy(), getattr(c, name)(Z_ARRAY),
                               rtol=RTOL, atol=0)


@pytest.mark.parametrize('cosmo', COSMOLOGIES)
@pytest.mark.parametrize('name', ['growth_factor', 'fsigma8',
                                  'comoving_distance', 'DV_over_rd'])
def test_autograd_against_jax_grad(cosmo, name):
    """d/dz by autograd on a tensor z against jax.grad of victor_tpu's
    method (growth quantities trace under jit there; the distances go
    through numpy there, so they are held to a central difference)."""
    t, j = TCosmo(COSMOLOGIES[cosmo]), JCosmo(COSMOLOGIES[cosmo])
    zt = torch.tensor(Z_ARRAY, requires_grad=True)
    getattr(t, name)(zt).sum().backward()
    if name in ('growth_factor', 'fsigma8'):
        want = np.array([float(jax.grad(getattr(j, name))(jnp.asarray(z)))
                         for z in Z_ARRAY])
        np.testing.assert_allclose(zt.grad.numpy(), want, rtol=1e-11)
    else:
        h = 1e-5
        want = (getattr(j, name)(Z_ARRAY + h) -
                getattr(j, name)(Z_ARRAY - h)) / (2 * h)
        np.testing.assert_allclose(zt.grad.numpy(), want, rtol=1e-7)


def test_eisenstein_hu_class_vs_jax():
    for args in ((0.675, 0.31, 0.048), (0.7, 0.28, 0.045, 0.97)):
        t, j = TEH(*args, device='cpu'), JEH(*args)
        assert t.sound_horizon == pytest.approx(j.sound_horizon, rel=RTOL)
        assert t.compute_sigma80() == pytest.approx(j.compute_sigma80(),
                                                    rel=RTOL)
        k = np.logspace(-4, 1, 40)
        got = t.power_EH(k)
        assert isinstance(got, np.ndarray) and got.shape == k.shape
        np.testing.assert_allclose(got, np.asarray(j.power_EH(k)), rtol=RTOL)
        assert float(t.power_EH(0.1)) == pytest.approx(float(j.power_EH(0.1)),
                                                       rel=RTOL)
        kt = torch.as_tensor(k.reshape(5, 8))
        assert t.power_EH(kt).shape == (5, 8)
    assert (t.h, t.omega_m, t.omega_b, t.ns, t.As) == \
        (j.h, j.omega_m, j.omega_b, j.ns, j.As)


def test_eisenstein_hu_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default builds there')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TEH(0.675, 0.31, 0.048)


def test_gauss_legendre_vs_jax():
    for n, a, b in ((8, -1.0, 1.0), (64, 0.0, 2.5), (128, 1e-5, 20.0)):
        for got, want in zip(tops.gauss_legendre(n, a, b),
                             jops.gauss_legendre(n, a, b)):
            np.testing.assert_array_equal(got, want)


def test_bicubic_cell_coeffs_vs_jax():
    """The per-cell bicubic coefficients equal victor_tpu's and reproduce
    RectBivariateSpline.ev inside each cell."""
    from scipy.interpolate import RectBivariateSpline
    rng = np.random.default_rng(4)
    x = np.cumsum(rng.uniform(0.5, 1.5, 9))
    y = np.cumsum(rng.uniform(0.5, 1.5, 7))
    z = rng.standard_normal((9, 7))
    A = tops.bicubic_cell_coeffs(x, y, z)
    np.testing.assert_array_equal(A, jops.bicubic_cell_coeffs(x, y, z))
    assert A.shape == (8, 6, 4, 4)
    i, jj, u, v = 3, 2, 0.3, 0.8
    q = x[i] + u * (x[i + 1] - x[i])
    p = y[jj] + v * (y[jj + 1] - y[jj])
    val = np.einsum('ab,a,b->', A[i, jj], u ** np.arange(4), v ** np.arange(4))
    want = RectBivariateSpline(x, y, z, kx=3, ky=3, s=0).ev(q, p)
    assert val == pytest.approx(float(want), abs=1e-12)
