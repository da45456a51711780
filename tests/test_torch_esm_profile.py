"""The port's ExcursionSetProfile class against victor_tpu's: the fiducial
sigma8 values, set_normalisation, power, the enclosed and local profiles,
density_evolution both ways, the snapshot semantics of the returned
callables, the pk_table route and the fallback warning. f64 on the CPU.
"""

import logging

import numpy as np
import pytest
import torch

from victor_tpu.models.esm import ExcursionSetProfile as J
from victor_tpu_torch.models.esm import ExcursionSetProfile as T

torch.set_num_threads(1)

ARGS = {'h': 0.675, 'omega_m': 0.31, 'omega_b': 0.048, 'z': 0.57}
PROFILE = (-1.544, -4.228, 7.973, 0.467)          # b10, b01, Rp, Rx
R = np.linspace(1.0, 120.0, 40)
RTOL = 1e-12


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    assert np.shape(got) == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())


@pytest.fixture(scope='module')
def pair():
    return J(**ARGS), T(**ARGS, device='cpu')


def test_fiducials_and_growth(pair):
    j, t = pair
    for name in ('s80_fiducial', 's8z_fiducial'):
        assert getattr(t, name) == pytest.approx(getattr(j, name), rel=RTOL)
    assert t.use_eisenstein_hu and t.normalisation == 1.0
    for z in (0.0, 0.57, 2.0):
        assert t.growth_factor(z) == pytest.approx(j.growth_factor(z),
                                                   rel=RTOL)


@pytest.mark.parametrize('z', [0.0, 0.57, 1.5])
def test_power_vs_jax(pair, z):
    j, t = pair
    k = np.logspace(-4, np.log10(2), 37)
    _close(t.power(k, z), j.power(k, z))
    assert isinstance(t.power(0.1, z), np.ndarray)


@pytest.mark.parametrize('z', [0.57, 0.3])
def test_profiles_vs_jax(pair, z):
    """The enclosed profile's callable at on- and off-grid radii, and the
    local profile's spline."""
    j, t = pair
    q = np.concatenate([R, [0.5, 3.3, 77.7]])
    _close(t.model_enclosed_density_profile(R, z, *PROFILE)(q),
           j.model_enclosed_density_profile(R, z, *PROFILE)(q))
    _close(t.model_density_profile(R, z, *PROFILE)(q),
           j.model_density_profile(R, z, *PROFILE)(q), 1e-11)


@pytest.mark.parametrize('norm', [(0.81, 0.0), (0.6, 0.57)])
@pytest.mark.parametrize('pairwise', [False, True])
def test_density_evolution_vs_jax(norm, pairwise):
    """After set_normalisation at z = 0 and z != 0, both ways."""
    j, t = J(**ARGS), T(**ARGS, device='cpu')
    j.set_normalisation(*norm)
    t.set_normalisation(*norm)
    assert t.normalisation == pytest.approx(j.normalisation, rel=RTOL)
    assert t._sigma8 == pytest.approx(j._sigma8, rel=RTOL)
    for r_max in (120, 80):
        # inside the x grid: beyond it the cubic extrapolation magnifies
        # the last bit of the Eulerian radii (1e-10 at 1.5 r_max)
        q = R[R <= r_max]
        _close(t.density_evolution(0.57, *PROFILE, r_max=r_max,
                                   pairwise=pairwise)(q),
               j.density_evolution(0.57, *PROFILE, r_max=r_max,
                                   pairwise=pairwise)(q))


def test_returned_callables_are_snapshots():
    """Each callable keeps its own call's z, x grid and normalisation: a
    later call with other values changes none handed out earlier."""
    t = T(**ARGS, device='cpu')
    enc = t.model_enclosed_density_profile(R, 0.57, *PROFILE)
    evo = t.density_evolution(0.57, *PROFILE, r_max=120)
    before = enc(R), evo(R)
    t.model_enclosed_density_profile(R, 1.2, *PROFILE)(R)
    t.density_evolution(1.2, *PROFILE, r_max=60)(R)
    t.set_normalisation(0.6)
    np.testing.assert_array_equal(enc(R), before[0])
    np.testing.assert_array_equal(evo(R), before[1])
    assert t._tables.z_eff.item() == 0.57
    assert t._tables.esm_x50 is None


def test_pk_table_route_vs_jax():
    """use_eisenstein_hu=False with a pk_table resamples it onto the
    instance's k grid with the same cubic spline, and takes its sigma8s."""
    k = np.logspace(-4.5, 0.5, 150)
    base = T(**ARGS, device='cpu')
    pk0 = base.power(k, 0.0) * 1.03
    table = {'k': k, 'pk0': pk0, 'sigma8_0': 0.83, 'sigma8_z': 0.61}
    j = J(**ARGS, use_eisenstein_hu=False, pk_table=table)
    t = T(**ARGS, use_eisenstein_hu=False, pk_table=table, device='cpu')
    assert not t.use_eisenstein_hu and t.s80_fiducial == 0.83
    assert t.s8z_fiducial == j.s8z_fiducial == 0.61
    kq = np.logspace(-3, 0, 9)
    _close(t.power(kq, 0.57), j.power(kq, 0.57))
    _close(t.model_enclosed_density_profile(R, 0.57, *PROFILE)(R),
           j.model_enclosed_density_profile(R, 0.57, *PROFILE)(R))


def test_without_pk_table_warns_and_falls_back(caplog):
    with caplog.at_level(logging.WARNING, logger='victor_tpu_torch.esm'):
        t = T(**ARGS, use_eisenstein_hu=False, device='cpu')
    assert t.use_eisenstein_hu
    assert any('requires pk_table' in r.getMessage() for r in caplog.records)
    ref = T(**ARGS, device='cpu')
    assert t.s80_fiducial == ref.s80_fiducial


def test_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default builds there')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T(**ARGS)
