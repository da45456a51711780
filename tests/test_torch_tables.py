"""victor_tpu_torch.io.tables.build_tables against victor_tpu's, leaf by leaf.

The host build is the same numpy/scipy code in both packages, so every leaf
must be bit-equal. Also here: the configurations that exercise the other
build branches, the .npz copies of the BOSS tables, bundle_from_arrays, and
a check that the port never imports jax.
"""

import copy
import dataclasses
import os
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch

from victor_tpu.io import build_tables as jax_build_tables
from victor_tpu_torch.io import loaders
from victor_tpu_torch.io.tables import (CCFTables, _NESTED, build_tables,
                                        bundle_from_arrays, tables_to_arrays)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEAVES = [f'{f.name}.{leaf}' if f.name in _NESTED else f.name
          for f in dataclasses.fields(CCFTables)
          for leaf in _NESTED.get(f.name, (None,))]
BOSS_FILES = [
    'CMASS_zobovVoids_reconRs10_0.43z0.7_medianRvcut_PatchyMean_model',
    'CMASS_zobovVoids_reconRs10_0.43z0.7_medianRvcut_data',
    'CMASS_zobovVoids_reconRs10_0.43z0.7_medianRvcut_variable_D_covariance',
]


def _assert_leaves_equal(got: dict, want: dict, keys=LEAVES):
    for key in keys:
        g, w = got[key], want[key]
        assert (g is None) == (w is None), key
        if g is not None:
            np.testing.assert_array_equal(g, w, err_msg=key)


@pytest.fixture(scope='module')
def boss_pair(boss_config):
    jb = jax_build_tables(boss_config['model'], boss_config['data'])
    tb = build_tables(boss_config['model'], boss_config['data'], device='cpu')
    return jb, tb


@pytest.mark.parametrize('leaf', LEAVES)
def test_boss_leaf_equals_jax(boss_pair, leaf):
    jb, tb = boss_pair
    _assert_leaves_equal(tables_to_arrays(tb.tables),
                         tables_to_arrays(jb.tables), [leaf])


def test_boss_leaf_dtypes_and_device(boss_pair):
    _, tb = boss_pair
    for leaf in LEAVES:
        owner, _, name = leaf.partition('.')
        v = getattr(getattr(tb.tables, owner), name) if name else \
            getattr(tb.tables, owner)
        if isinstance(v, torch.Tensor):
            assert v.dtype == torch.float64 and v.device.type == 'cpu', leaf


def test_boss_spec_and_options_equal_jax(boss_pair):
    jb, tb = boss_pair
    assert dataclasses.asdict(tb.spec) == dataclasses.asdict(jb.spec)
    assert dataclasses.asdict(tb.theory_opts) == \
        dataclasses.asdict(jb.theory_opts)
    assert dataclasses.asdict(tb.fit_opts) == dataclasses.asdict(jb.fit_opts)


def test_bundle_from_arrays_round_trip(boss_pair):
    jb, tb = boss_pair
    rb = bundle_from_arrays(tables_to_arrays(jb.tables),
                            dataclasses.asdict(jb.spec),
                            dataclasses.asdict(jb.theory_opts),
                            dataclasses.asdict(jb.fit_opts), device='cpu')
    _assert_leaves_equal(tables_to_arrays(rb.tables),
                         tables_to_arrays(tb.tables))
    assert rb.spec == tb.spec and rb.theory_opts == tb.theory_opts
    assert rb.fit_opts == tb.fit_opts


def test_to_float32(boss_pair):
    _, tb = boss_pair
    t32 = tb.to('cpu', torch.float32).tables
    assert t32.cov.dtype == torch.float32
    assert t32.sv_surf.cu.dtype == torch.float32 and t32.sv_surf.y_const
    np.testing.assert_allclose(t32.cov.numpy(), tb.tables.cov.numpy(),
                               rtol=1e-7)


def _model_file_with(tmp_path, extra: dict, drop=()):
    """A copy of the BOSS model file with extra keys, minus `drop`."""
    src = os.path.join(REPO, 'data', 'BOSS_DR12_CMASS_data',
                       BOSS_FILES[0] + '.hdf5')
    with h5py.File(src) as f:
        payload = {k: f[k][:] for k in f if k not in drop}
    fn = tmp_path / 'model.hdf5'
    with h5py.File(fn, 'w') as f:
        for k, v in {**payload, **extra}.items():
            f.create_dataset(k, data=v)
    return str(fn)


def _variant(name, cfg, tmp_path):
    model = copy.deepcopy(cfg['model'])
    if name == 'linear_bias':
        model['matter_ccf'] = {'model': 'linear_bias', 'bias': 1.9,
                               'template_sigma8': 0.628}
    elif name == 'rmu_template_mean_2d_dispersion':
        with h5py.File(os.path.join(model['dir'],
                                    model['input_model_data_file'])) as f:
            r, mono, quad = f['r'][:], f['monopole'][:], f['quadrupole'][:]
            rsv, sigmav = f['rsv'][:], f['sigmav'][:]
        mu = np.linspace(0.0, 1.0, 64)
        mu_sv = np.linspace(0.0, 1.0, 21)
        model['input_model_data_file'] = _model_file_with(tmp_path, {
            'mu': mu,
            'xi_rmu': mono[15][:, None] + quad[15][:, None]
            * (1.5 * mu ** 2 - 0.5)[None, :],
            'rv': r, 'vr': -120.0 * (r / 30.0) * np.exp(-r / 35.0),
            'musv': mu_sv,
            'sigmav2d': sigmav[:, None] * (1.0 + 0.25 * mu_sv[None, :] ** 2)},
            drop=('monopole', 'quadrupole', 'beta'))
        model['dir'] = ''
        model['realspace_ccf'] = {'reconstruction': False, 'format': 'rmu',
                                  'ccf_keys': ['r', 'mu', 'xi_rmu']}
        model['velocity_pdf']['mean'] = {
            'model': 'template', 'template_fsigma8': 0.45, 'z_sim': 0.0,
            'template_keys': ['rv', 'vr']}
        model['velocity_pdf']['dispersion'] = {
            'model': 'template', 'template_keys': ['rsv', 'musv', 'sigmav2d']}
        assert len(rsv) == 25
    elif name == 'example_fixed_constant_dispersion':
        model = {**model,
                 'input_model_data_file':
                     'data/example_data/example_void_model.hdf5',
                 'realspace_ccf': {'reconstruction': False,
                                   'format': 'multipoles',
                                   'ccf_keys': ['r', 'monopole']},
                 'matter_ccf': {**model['matter_ccf'], 'integrated': True}}
        model['velocity_pdf'] = {'mean': {'model': 'linear'},
                                 'dispersion': {'model': 'constant'}}
    return model


@pytest.mark.parametrize('name', ['linear_bias',
                                  'rmu_template_mean_2d_dispersion',
                                  'example_fixed_constant_dispersion'])
def test_model_only_variants_equal_jax(boss_config, tmp_path, name):
    """The build branches the BOSS config does not take: linear-bias
    operators, (r, mu) input, the velocity-mean template, a mu-dependent
    dispersion surface, the integrated template and constant dispersion."""
    model = _variant(name, boss_config, tmp_path)
    jb = jax_build_tables(copy.deepcopy(model))
    tb = build_tables(copy.deepcopy(model), device='cpu')
    _assert_leaves_equal(tables_to_arrays(tb.tables),
                         tables_to_arrays(jb.tables))
    assert dataclasses.asdict(tb.spec) == dataclasses.asdict(jb.spec)
    assert tb.fit_opts is None


@pytest.mark.parametrize('esm_opts', [{'use_eisenstein_hu': True}, {}])
def test_excursion_set_equal_jax(boss_config, esm_opts, caplog):
    """The excursion-set fixtures: the k grid, its weights, the 50-point
    evolution grid and the Eisenstein-Hu flag; a CAMB request without a
    table falls back to Eisenstein-Hu with a warning. The CAMB table and
    grid modes are in test_torch_esm.py."""
    model = copy.deepcopy(boss_config['model'])
    model['matter_ccf'] = {'model': 'excursion_set',
                           'excursion_set_options': esm_opts}
    jb = jax_build_tables(copy.deepcopy(model))
    with caplog.at_level('WARNING', logger='victor_tpu_torch.io'):
        tb = build_tables(copy.deepcopy(model), device='cpu')
    _assert_leaves_equal(tables_to_arrays(tb.tables),
                         tables_to_arrays(jb.tables))
    assert dataclasses.asdict(tb.spec) == dataclasses.asdict(jb.spec)
    assert tb.spec.esm_use_eh and tb.tables.esm_k.shape == (200,)
    assert ('falling back to the Eisenstein-Hu' in caplog.text) == \
        (not esm_opts)


@pytest.mark.parametrize('entry', ['build_tables', 'bundle_from_arrays'])
def test_default_device_is_the_card(boss_config, boss_pair, monkeypatch,
                                    entry):
    """Left at its default, the device is CUDA: without a card the entry
    points raise rather than carry on on the CPU."""
    jb, _ = boss_pair
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device.*device='cpu'"):
        if entry == 'build_tables':
            build_tables(boss_config['model'], boss_config['data'])
        else:
            bundle_from_arrays(tables_to_arrays(jb.tables),
                               dataclasses.asdict(jb.spec),
                               dataclasses.asdict(jb.theory_opts),
                               dataclasses.asdict(jb.fit_opts))


@pytest.mark.parametrize('name', BOSS_FILES)
def test_npz_copies_equal_hdf5(name):
    hdf5 = loaders.load_key_value_file(
        os.path.join(REPO, 'data', 'BOSS_DR12_CMASS_data', name + '.hdf5'))
    npz = loaders.load_key_value_file(
        os.path.join(REPO, 'data', 'BOSS_DR12_CMASS_npz', name + '.npz'))
    assert sorted(hdf5) == sorted(npz)
    for key in hdf5:
        np.testing.assert_array_equal(npz[key], hdf5[key], err_msg=key)
        assert npz[key].dtype == hdf5[key].dtype


def test_port_imports_without_jax():
    """Import every victor_tpu_torch module in a process where importing
    jax or the JAX package raises. The package's own import (the class
    surface it exports) builds no kernel and imports neither matplotlib
    nor h5py."""
    code = '''
import importlib, pkgutil, sys
class NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'victor_tpu'):
            raise ImportError(name + ' is blocked')
sys.meta_path.insert(0, NoJax())
import victor_tpu_torch
from victor_tpu_torch.kernels import _build
assert not _build._LOADED
assert set(victor_tpu_torch.__all__) >= {
    'BackgroundCosmology', 'CCFModel', 'CCFFit', 'ExcursionSetProfile',
    'plottools', 'utils'}
assert not any(m.split('.')[0] in ('matplotlib', 'h5py') for m in sys.modules)
names = [m.name for m in pkgutil.walk_packages(victor_tpu_torch.__path__,
                                                'victor_tpu_torch.')]
for name in names:
    importlib.import_module(name)
assert not any(m.split('.')[0] in ('jax', 'victor_tpu') for m in sys.modules)
print(' '.join(names))
'''
    env = {**os.environ, 'PYTHONPATH': REPO}
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert {f'victor_tpu_torch.{m}' for m in (
        '__main__', 'utils.logging', 'likelihood.multiquantile',
        'sampling.priors', 'sampling.diagnostics', 'sampling.ensemble',
        'sampling.chains', 'sampling.targets', 'sampling.hmc', 'sampling.mh',
        'sampling.nuts', 'sampling.runner', 'sampling.smc',
        'sampling.nested', 'sampling.post', 'sampling.tension',
        'kernels.ppoly', 'api', 'plottools', 'likelihoods',
        'likelihoods.CCFLikelihood', 'utils.multipoles', 'utils.converters',
        'models.cosmology', 'models.eisenstein_hu', 'models.esm',
        'parallel', 'parallel.mesh', 'parallel.probe', 'utils.profiling',
        'utils.watchdog')} <= names
    assert len(names) >= 57
    # the backward kernel is built from the forward's source, and launched
    # from the module imported above
    with open(os.path.join(REPO, 'victor_tpu_torch', 'kernels', 'csrc',
                           'ppoly_eval.cu')) as f:
        src = f.read()
    assert 'ppoly_eval_backward_f64' in src and 'ppoly_bwd_reduce' in src


def test_tools_import_without_jax():
    """The port's tools and walkthroughs (tools/*_torch.py,
    examples/*_torch.py) import in a process where importing jax or the JAX
    package raises, and import neither."""
    code = '''
import glob, importlib, os, sys
class NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'victor_tpu'):
            raise ImportError(name + ' is blocked')
sys.meta_path.insert(0, NoJax())
sys.path[:0] = ['tools', 'examples']
names = sorted(os.path.basename(p)[:-3] for d in ('tools', 'examples')
               for p in glob.glob(os.path.join(d, '*_torch.py')))
for name in names:
    importlib.import_module(name)
assert not any(m.split('.')[0] in ('jax', 'victor_tpu') for m in sys.modules)
print(' '.join(names))
'''
    env = {**os.environ, 'PYTHONPATH': REPO}
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [
        'coverage_test_torch', 'inference_demo_torch',
        'make_camb_table_torch', 'make_notebooks_torch',
        'model_options_demo_torch', 'multiquantile_demo_torch',
        'plot_chains_torch', 'tension_injection_probe_torch',
        'usage_demo_torch', 'validate_camb_grid_torch',
        'validate_dispersion_fast_torch', 'validate_posterior_torch']
