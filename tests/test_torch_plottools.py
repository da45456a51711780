"""The port's plottools and utils (multipoles, converters) against
victor_tpu's: the arrays each plot draws, the multipole transforms even and
odd, and the HDF5 files the converters write. Host code, under Agg.
"""

import json

import h5py
import matplotlib
import numpy as np
import pytest

matplotlib.use('Agg')
import matplotlib.pyplot as plt  # noqa: E402

from victor_tpu import plottools as jplot  # noqa: E402
from victor_tpu import utils as jutils  # noqa: E402
from victor_tpu_torch import plottools as tplot  # noqa: E402
from victor_tpu_torch import utils as tutils  # noqa: E402
from victor_tpu_torch.api import Interp2D  # noqa: E402


def _xi(rs, rp):
    """A void-like ccf on the (r_perp, r_par) tensor grid: (len(rp), len(rs))."""
    r = np.hypot(np.asarray(rs)[None, :], np.asarray(rp)[:, None])
    mu = np.asarray(rp)[:, None] / np.maximum(r, 1e-9)
    return -0.8 * np.exp(-(r / 30.0) ** 2) * (1 + 0.3 * mu ** 2) + 0.05


@pytest.mark.parametrize('kw', [{}, {'midpoint': 0.8}, {'midpoint': 0.2},
                                {'start': 0.1, 'midpoint': 0.6, 'stop': 0.9},
                                {'midpoint': 0.0}, {'midpoint': 1.0}])
def test_shifted_color_map_vs_jax(kw):
    x = np.linspace(0, 1, 33)
    got = tplot.shifted_color_map(matplotlib.cm.RdYlBu_r, **kw,
                                  name='port_shift')
    want = jplot.shifted_color_map(matplotlib.cm.RdYlBu_r, **kw,
                                   name='jax_shift')
    np.testing.assert_array_equal(got(x), want(x))
    assert got.name == 'port_shift'


@pytest.mark.parametrize('even', [True, False])
def test_mirror_plane_vs_jax(even):
    rs, rp = np.linspace(1, 50, 7), np.linspace(1, 40, 5)
    grid = np.random.default_rng(1).standard_normal((5, 7))
    for got, want in zip(tplot._mirror_plane(grid, rs, rp, even),
                         jplot._mirror_plane(grid, rs, rp, even)):
        np.testing.assert_array_equal(got, want)


def _mesh_data(ax):
    """The mesh's array and coordinates, and every contour path's vertices."""
    mesh = ax.collections[0]
    out = [np.asarray(mesh.get_array()), np.asarray(mesh.get_coordinates())]
    for c in ax.collections[1:]:
        out += [p.vertices for p in c.get_paths()]
    return out


@pytest.mark.parametrize('case', ['default', 'half-plane', 'rp-none',
                                  'labels'])
def test_plot_2D_ccf_vs_jax(case):
    rs = np.linspace(1, 59, 30)
    kw = {'default': dict(contours=[-0.5, -0.2, 0.0], clabel=True),
          'half-plane': dict(rp=np.linspace(-40, 40, 21), even=False,
                             shift=False, contours=[-0.3]),
          'rp-none': dict(colorbar=False, vmin=-0.9, vmax=0.1),
          'labels': dict(xlabel='x', axis_label='s', cbar_label='xi')}[case]
    out = []
    for mod in (tplot, jplot):
        fig, ax = plt.subplots()
        assert mod.plot_2D_ccf(_xi, rs, ax=ax, **kw) is ax
        out.append((_mesh_data(ax), ax.get_xlim(), ax.get_ylim(),
                    ax.get_xlabel(), ax.get_ylabel(),
                    list(ax.get_yticks())))
        plt.close(fig)
    (got, *got_rest), (want, *want_rest) = out
    assert got_rest == want_rest
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_plot_2D_ccf_of_an_interp2d():
    """plot_2D_ccf on the port's Interp2D, as a notebook calls it on
    theory_xi_2D's result."""
    sperp, spar = np.linspace(0.01, 60), np.linspace(-60, 60)
    f = Interp2D(sperp, spar, _xi(sperp, spar))
    fig, ax = plt.subplots()
    tplot.plot_2D_ccf(f, np.linspace(1, 59, 30), contours=[-0.5], ax=ax)
    assert np.isfinite(np.asarray(ax.collections[0].get_array())).all()
    plt.close(fig)


def _figure_data(fig):
    out = []
    for ax in fig.axes:
        if not ax.get_visible():
            continue
        out += [p.get_path().vertices for p in ax.patches]
        out += [p.vertices for c in ax.collections for p in c.get_paths()]
        out += [np.array([ax.get_xlabel(), ax.get_ylabel()], dtype=object)]
    return out


@pytest.mark.parametrize('kw', [{}, {'params': ['c', 'a']},
                                {'weights': True, 'bins': 20}])
def test_corner_plot_vs_jax(kw, tmp_path):
    rng = np.random.default_rng(3)
    samples = rng.standard_normal((600, 3)) @ np.array(
        [[1.0, 0.3, 0.0], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]])
    kw = dict(kw)
    if kw.pop('weights', False):
        kw['weights'] = rng.random(600)
    figs = [mod.corner_plot(samples, ['a', 'b', 'c'], **kw)
            for mod in (tplot, jplot)]
    got, want = (_figure_data(f) for f in figs)
    for f in figs:
        plt.close(f)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    out = tplot.corner_plot(samples, ['a', 'b', 'c'],
                            str(tmp_path / 'corner.png'), **kw)
    with open(out, 'rb') as f:
        assert f.read(8) == b'\x89PNG\r\n\x1a\n'


@pytest.mark.parametrize('even', [True, False])
def test_multipoles_from_fn_vs_jax(even):
    """Legendre multipoles of f(r, mu), for a 1D callable and an
    interp2d-convention one."""
    r = np.linspace(5, 100, 12)

    def f(rr, mu):
        return np.exp(-rr / 40.0) * (1 + 0.5 * mu + 0.8 * mu ** 2)
    sperp = np.linspace(0, 110, 60)
    mu_grid = np.linspace(-1, 1, 41)
    f2d = Interp2D(sperp, mu_grid, f(sperp[None, :], mu_grid[:, None]))
    for fn in (f, f2d):
        got = tutils.multipoles_from_fn(fn, r, ell=(0, 1, 2, 4), even=even)
        want = jutils.multipoles_from_fn(fn, r, ell=(0, 1, 2, 4), even=even)
        assert list(got) == list(want) == ['0', '1', '2', '4']
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-14)


@pytest.mark.parametrize('poles', [(0, 2), (0, 1, 2, 3), 2])
def test_fn_from_multipoles_vs_jax(poles):
    """The rebuilt f(r, mu) is the port's Interp2D (linear, as the
    reference's interp2d) with victor_tpu's values on and off the nodes."""
    r = np.linspace(5, 100, 12)
    n = 1 if isinstance(poles, int) else len(poles)
    m = np.random.default_rng(2).standard_normal((n, len(r)))
    got = tutils.fn_from_multipoles(r, poles, m)
    want = jutils.fn_from_multipoles(r, poles, m)
    assert isinstance(got, Interp2D)
    for x, y in ((r, np.linspace(-1, 1, 9)), (np.array([7.7, 51.2]),
                                              np.array([-0.33, 0.41]))):
        np.testing.assert_allclose(got(x, y), want(x, y), rtol=0, atol=1e-14)
    with pytest.raises(ValueError, match='Wrong shape'):
        tutils.fn_from_multipoles(r, (0, 2), m[:1, :5])


def _datasets(path):
    with h5py.File(path) as f:
        return {k: f[k][()] for k in f}


def _assert_same_files(a, b):
    da, db = _datasets(a), _datasets(b)
    assert set(da) == set(db) and da
    for k in db:
        np.testing.assert_array_equal(da[k], db[k], err_msg=k)


def test_old_model_and_data_converters_vs_jax(tmp_path):
    r = np.linspace(5, 120, 24)
    mult = np.concatenate([np.sin(r / 50), np.cos(r / 50)])
    np.save(tmp_path / 'real.npy', {'rvals': r, 'multipoles': mult})
    np.save(tmp_path / 'matter.npy', {'rvals': r, 'delta': -np.exp(-r / 30)})
    np.save(tmp_path / 'vel.npy', {'rvals': r, 'sigma_v_los': 300 + r})
    beta = np.linspace(0.3, 0.5, 5)
    np.save(tmp_path / 'red.npy', {'rvals': r, 'multipoles': np.tile(mult,
                                                                     (5, 1))})
    np.save(tmp_path / 'beta.npy', beta)
    np.save(tmp_path / 'cov.npy', np.eye(48) * 1e-4)
    np.save(tmp_path / 'covstack.npy', np.stack([np.eye(48)] * 5))
    for name, mod in (('t', tutils), ('j', jutils)):
        mod.convert_old_model_files_to_hdf5(
            tmp_path / 'real.npy', tmp_path / f'{name}_model.hdf5',
            matter_ccf_file=tmp_path / 'matter.npy',
            velocity_file=tmp_path / 'vel.npy', beta_file=tmp_path / 'beta.npy')
        mod.convert_old_data_files_to_hdf5(
            tmp_path / 'red.npy', tmp_path / f'{name}_data.hdf5',
            beta_file=tmp_path / 'beta.npy',
            covmat_file=tmp_path / 'covstack.npy',
            output_covmat_file=tmp_path / f'{name}_cov.hdf5',
            beta_cov_file=tmp_path / 'beta.npy')
        mod.convert_old_data_files_to_hdf5(
            tmp_path / 'real.npy', tmp_path / f'{name}_fixed.hdf5',
            covmat_file=tmp_path / 'cov.npy',
            output_covmat_file=tmp_path / f'{name}_fixedcov.hdf5')
    for stem in ('model', 'data', 'cov', 'fixed', 'fixedcov'):
        _assert_same_files(tmp_path / f't_{stem}.hdf5',
                           tmp_path / f'j_{stem}.hdf5')
    assert set(_datasets(tmp_path / 't_model.hdf5')) == {
        'r', 'beta', 'monopole', 'quadrupole', 'rdelta', 'delta', 'rsv',
        'sigmav'}


@pytest.mark.parametrize('recon', [True, False])
def test_quijote_converter_vs_jax(tmp_path, recon):
    rng = np.random.default_rng(0)
    txt = 'RECON' if recon else 'REAL'
    nmock, nr = 6, 8
    r = np.linspace(5, 100, nr).tolist()
    mocks = []
    for _ in range(nmock):
        entry = {}
        for stem in [f'CCF_multipole_Halo_{txt}_Void_{txt}',
                     f'CCF_multipole_Halo_RSD_Void_{txt}']:
            entry[f'{stem}_radius'] = r
            for ell in (0, 2, 4):
                entry[f'{stem}_xi{ell}'] = rng.normal(size=nr).tolist()
        for stem, keys in [(f'profile_DM_REAL_Void_{txt}', ['delta', 'Delta']),
                           (f'profile_Halo_REAL_Void_{txt}', ['v', 'sigma'])]:
            entry[f'{stem}_radius'] = r
            for kk in keys:
                entry[f'{stem}_{kk}'] = rng.normal(size=nr).tolist()
        mocks.append(entry)
    with open(tmp_path / 'quijote.json', 'w') as f:
        json.dump(mocks, f)
    for name, mod in (('t', tutils), ('j', jutils)):
        mod.convert_hans_quijote_to_hdf5(tmp_path / 'quijote.json',
                                         tmp_path / f'{name}.hdf5',
                                         reconvoids=recon)
    _assert_same_files(tmp_path / 't.hdf5', tmp_path / 'j.hdf5')
    assert _datasets(tmp_path / 't.hdf5')['D_ell024_covmat'].shape == (24, 24)
