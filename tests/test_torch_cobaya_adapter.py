"""The port's cobaya adapter (`victor_tpu_torch.likelihoods.CCFLikelihood`)
through cobaya's component-construction flow, against victor_tpu's adapter.

cobaya is not installable here, so this file keeps its own copy of
tests/test_cobaya_adapter.py's versioned interface double, frozen against
**cobaya 3.5**: the adjacent `<ClassName>.yaml` class defaults merged under
the input info, the merged non-`params` keys injected as attributes, then
`initialize()`; the base `get_requirements()` default (no requirements);
`calculate(state, want_derived, **params)` filling `state['logp']` and
`state['derived']`; `get_can_provide_params()`; string `value: "lambda
..."` derived parameters evaluated by cobaya itself. The adapters build
their tables on the CPU (`device: cpu` in the input info).
"""

import importlib
import os
import sys
import types

import numpy as np
import pytest
import torch
import yaml

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COBAYA_CONTRACT_VERSION = '3.5'
PORT = 'victor_tpu_torch.likelihoods.CCFLikelihood'
JAX = 'victor_tpu.likelihoods.CCFLikelihood'
GOLDEN = {'fsigma8': 0.47, 'beta': 0.37, 'sigma_v': 380.0, 'epsilon': 1.0}
DISPLACED = {'fsigma8': 0.55, 'beta': 0.45, 'sigma_v': 320.0, 'epsilon': 1.05}
ESM_REF = {'f': 0.78, 'sigma_8_0': 0.81, 'b10': -1.544, 'b01': -4.228,
           'Rp': 7.973, 'Rx': 0.467, 'beta': 0.4, 'sigma_v': 380.0,
           'epsilon': 1.0}


def _double_modules():
    cobaya = types.ModuleType('cobaya')
    cobaya.__version__ = COBAYA_CONTRACT_VERSION
    lik = types.ModuleType('cobaya.likelihood')

    class Likelihood:
        """Attribute-bag contract the adapter subclasses, with the cobaya-3.5
        base-class defaults the adapter is expected to inherit (NOT shadow)."""

        def get_requirements(self):
            # cobaya.theory.Theory.get_requirements default: no requirements
            return {}

        def calculate(self, state, want_derived=True, **params_values):
            # cobaya.likelihood.Likelihood.calculate default delegates to
            # logp(); the adapter overrides calculate wholesale instead
            state['logp'] = self.logp(**params_values)

    lik.Likelihood = Likelihood
    cobaya.likelihood = lik
    return {'cobaya': cobaya, 'cobaya.likelihood': lik}


def _reload(name):
    return importlib.reload(importlib.import_module(name))


def _build_component(info: dict, module=PORT):
    """cobaya's component construction, minimally: reload the adapter module
    (so it binds the installed double), merge the adjacent CCFLikelihood.yaml
    class defaults under the input info, inject merged non-params keys as
    attributes, call initialize(). Returns (instance, merged params block)."""
    mod = _reload(module)
    with open(os.path.join(os.path.dirname(mod.__file__),
                           'CCFLikelihood.yaml')) as f:
        defaults = yaml.safe_load(f) or {}
    merged = dict(defaults)
    merged.update(info)
    params = merged.pop('params', {}) or {}
    obj = mod.CCFLikelihood()
    for key, val in merged.items():
        setattr(obj, key, val)
    obj.initialize()
    return obj, params


def _config(name):
    with open(os.path.join(REPO, 'configs', name)) as f:
        cfg = yaml.safe_load(f)
    cfg['model']['dir'] = cfg['data']['dir'] = REPO
    return cfg


@pytest.fixture(scope='module')
def double():
    """The cobaya-3.5 double installed for the module; afterwards both
    adapter modules are reloaded in their cobaya-absent state."""
    with pytest.MonkeyPatch.context() as mp:
        for name, mod in _double_modules().items():
            mp.setitem(sys.modules, name, mod)
        yield
    for name in (PORT, JAX):
        _reload(name)


@pytest.fixture(scope='module')
def built(double):
    """{(package, config): (adapter, params block)} for the BOSS and the ESM
    config, the port's on the CPU."""
    out = {}
    for key, name in (('boss', 'boss_config.yaml'),
                      ('esm', 'esm_sampling_config.yaml')):
        cfg = _config(name)
        info = {'model': cfg['model'], 'data': cfg['data']}
        out['port', key] = _build_component({**info, 'device': 'cpu'})
        out['jax', key] = _build_component(info, JAX)
    return out


def _calc(obj, point, want_derived=True):
    state = {}
    obj.calculate(state, want_derived=want_derived, **point)
    return state


@pytest.mark.parametrize('point', [GOLDEN, DISPLACED],
                         ids=['golden', 'displaced'])
def test_defaults_merge_and_calculate(built, point):
    """Built through the defaults merge: the class defaults the info did not
    override survive, and calculate() equals CCFFit's log_likelihood and
    victor_tpu's adapter."""
    obj, params = built['port', 'boss']
    assert obj.config_file == 'configs/boss_config.yaml'
    assert obj.device == 'cpu' and obj.ccf_fit.device.type == 'cpu'
    assert 'chi2_ccf_correct' in params and params['chi2_ccf_correct']['derived']
    state = _calc(obj, point)
    lnl, chi2 = obj.ccf_fit.log_likelihood(dict(point))
    assert state['logp'] == lnl
    assert state['derived'] == {'chi2_ccf_correct': chi2}
    want = _calc(built['jax', 'boss'][0], point)
    assert abs(state['logp'] - want['logp']) < 1e-9
    assert abs(chi2 - want['derived']['chi2_ccf_correct']) < 1e-9
    if point is GOLDEN:
        assert round(state['logp'], 6) == 284.764389
        assert round(chi2, 6) == 65.011778


def test_derived_ap_lambdas(built):
    """cobaya evaluates string `value:` lambdas for derived params; the
    shipped defaults reproduce the reference's a_perp/a_par relations
    (victor/likelihoods/CCFLikelihood.yaml:14-19)."""
    _, params = built['port', 'boss']
    fns = {name: eval(spec['value'])        # what cobaya itself does
           for name, spec in params.items()
           if isinstance(spec, dict) and isinstance(spec.get('value'), str)}
    assert set(fns) == {'aperp', 'apar'}
    alpha, epsilon = 1.02, 0.97
    aperp, apar = fns['aperp'](alpha, epsilon), fns['apar'](alpha, epsilon)
    np.testing.assert_allclose(aperp / apar, epsilon, rtol=1e-12)
    np.testing.assert_allclose(aperp ** 2 * apar, alpha ** 3, rtol=1e-12)


def test_config_file_route(built, tmp_path):
    """A likelihood block carrying only config_file (no inline model/data)
    loads the YAML and gives the inline route's logp; a missing file
    raises."""
    p = tmp_path / 'cfg.yaml'
    p.write_text(yaml.safe_dump(_config('boss_config.yaml')))
    obj, _ = _build_component({'model': None, 'data': None,
                               'config_file': str(p), 'device': 'cpu'})
    assert _calc(obj, GOLDEN) == _calc(built['port', 'boss'][0], GOLDEN)
    with pytest.raises(FileNotFoundError, match='config_file'):
        _build_component({'model': None, 'data': None, 'device': 'cpu',
                          'config_file': str(tmp_path / 'absent.yaml')})


@pytest.mark.parametrize('which', ['boss', 'esm'])
def test_contract_requirements_and_provides(built, which):
    """The base get_requirements() default is inherited, not shadowed; the
    derived fsigma8 is advertised for the excursion-set config only; every
    advertised name appears in state['derived']."""
    obj, _ = built['port', which]
    assert obj.get_requirements() == {}
    assert 'get_requirements' not in type(obj).__dict__
    provides = obj.get_can_provide_params()
    assert provides == built['jax', which][0].get_can_provide_params()
    assert provides == (['chi2_ccf_correct', 'fsigma8'] if which == 'esm'
                        else ['chi2_ccf_correct'])
    state = _calc(obj, ESM_REF if which == 'esm' else GOLDEN)
    assert set(provides) == set(state['derived'])


def test_esm_derived_fsigma8_vs_jax(built):
    """f * sigma8(z_eff) through the port's esm_s8z against victor_tpu's
    adapter, computed only when cobaya wants derived values."""
    obj, _ = built['port', 'esm']
    got = _calc(obj, ESM_REF)
    want = _calc(built['jax', 'esm'][0], ESM_REF)
    assert abs(got['logp'] - want['logp']) < 1e-9
    for k in ('chi2_ccf_correct', 'fsigma8'):
        assert abs(got['derived'][k] - want['derived'][k]) < 1e-9, k
    assert 0.4 < got['derived']['fsigma8'] < 0.6
    lean = _calc(obj, ESM_REF, want_derived=False)
    assert lean['logp'] == got['logp']
    assert set(lean['derived']) == {'chi2_ccf_correct'}


def test_import_gate_without_cobaya():
    """Without cobaya the module imports, and initialize() raises."""
    saved = {k: sys.modules.pop(k) for k in ('cobaya', 'cobaya.likelihood')
             if k in sys.modules}
    try:
        mod = _reload(PORT)
        assert not mod._HAVE_COBAYA
        lk = mod.CCFLikelihood.__new__(mod.CCFLikelihood)
        with pytest.raises(ImportError, match='cobaya is not installed'):
            lk.initialize()
    finally:
        sys.modules.update(saved)
        _reload(PORT)


class TestVersionCanary:
    """A cobaya of another major/minor version makes the import warn."""

    def test_matching_version_is_silent(self, double, recwarn):
        _reload(PORT)
        assert not [w for w in recwarn.list
                    if 'frozen against' in str(w.message)]

    def test_version_drift_warns(self, double, monkeypatch):
        monkeypatch.setattr(sys.modules['cobaya'], '__version__', '4.0.2')
        try:
            with pytest.warns(UserWarning,
                              match='frozen against the cobaya-3.5'):
                _reload(PORT)
        finally:
            monkeypatch.undo()
            _reload(PORT)


def test_yaml_vocabulary_equals_victor_tpus():
    """The class defaults carry victor_tpu's (the reference's) parameter
    vocabulary unchanged, plus one top-level `device: cuda`."""
    import victor_tpu.likelihoods as jpkg
    import victor_tpu_torch.likelihoods as tpkg
    got, want = ({}, {})
    for pkg, out in ((tpkg, got), (jpkg, want)):
        with open(os.path.join(os.path.dirname(pkg.__file__),
                               'CCFLikelihood.yaml')) as f:
            out.update(yaml.safe_load(f))
    assert got['params'] == want['params']
    assert set(got) == set(want) | {'device'} and got['device'] == 'cuda'
    assert {k: got[k] for k in want} == want
    assert tpkg.CCFLikelihood.device == 'cuda'


def test_the_card_is_the_default(double):
    """Without `device` the adapter builds on the card, and on a machine
    without one it raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default builds there')
    cfg = _config('boss_config.yaml')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _build_component({'model': cfg['model'], 'data': cfg['data']})
