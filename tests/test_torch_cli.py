"""`python -m victor_tpu_torch` (run, eval, fit, scan, forecast, bench)
against victor_tpu's CLI.

The port's `main([...,'--device', 'cpu'])` and victor_tpu's `main([...])`
run on the same configs in one process; their JSON and their chain files
are compared. The optimizer commands build both packages' tables at a
narrow width (the `narrow` fixture). Also recomputes the eval goldens that
chip_smoke.py holds the card to.
"""

import ast
import copy
import json
import os

import numpy as np
import pytest
import torch
import yaml

from victor_tpu.__main__ import main as jmain
from victor_tpu_torch.__main__ import main as tmain

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_ARGS = ['--param', 'fsigma8=0.47', '--param', 'beta=0.37',
               '--param', 'sigma_v=380', '--param', 'epsilon=1.0']


def _literals(path, *names):
    """Literals assigned at the top level of the Python file `path` (read
    with ast: importing chip_smoke.py would install its import hook that
    refuses jax)."""
    tree = ast.parse(open(os.path.join(REPO, path)).read())
    return {t.id: ast.literal_eval(node.value) for node in tree.body
            if isinstance(node, ast.Assign) for t in node.targets
            if isinstance(t, ast.Name) and t.id in names}


def _chip_smoke_literals(*names):
    found = _literals('chip_smoke.py', *names)
    return tuple(found[n] for n in names)


def _write(tmp_path, cfg, name='cfg.yaml'):
    path = tmp_path / name
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.fixture()
def sampling_cfg():
    """configs/boss_sampling_config.yaml with absolute data paths."""
    with open(os.path.join(REPO, 'configs', 'boss_sampling_config.yaml')) as f:
        cfg = yaml.safe_load(f)
    cfg['model']['dir'] = cfg['data']['dir'] = REPO
    return cfg


@pytest.fixture()
def joint_cfg(sampling_cfg, tmp_path):
    """Two copies of the BOSS data under the block-diagonal stack of its
    beta-dependent covariance (tests/test_multiquantile.py)."""
    import h5py
    from victor_tpu_torch.io.loaders import load_key_value_file
    cdict = load_key_value_file(os.path.join(
        REPO, sampling_cfg['data']['covariance_matrix']['data_file']))
    covs = np.asarray(cdict['covmat'])
    D = covs.shape[1]
    joint = np.zeros((len(covs), 2 * D, 2 * D))
    joint[:, :D, :D] = joint[:, D:, D:] = covs
    with h5py.File(tmp_path / 'joint_cov.hdf5', 'w') as f:
        f.create_dataset('covmat', data=joint)
        f.create_dataset('beta', data=np.asarray(cdict['beta']))
    q = {'model': copy.deepcopy(sampling_cfg['model']),
         'data': {'redshift_space_ccf': copy.deepcopy(
             sampling_cfg['data']['redshift_space_ccf']), 'dir': REPO}}
    return {'quantiles': [copy.deepcopy(q), copy.deepcopy(q)],
            'covariance_matrix': {
                'data_file': str(tmp_path / 'joint_cov.hdf5'),
                'cov_key': 'covmat', 'fixed_beta': False,
                'beta_key': 'beta'},
            'likelihood': {'form': 'sellentin', 'nmocks': 1000,
                           'nparams': 4},
            'params': copy.deepcopy(sampling_cfg['params'])}


def _json(capsys):
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize('which', ['single', 'joint'])
@pytest.mark.parametrize('args', [GOLDEN_ARGS, []], ids=['golden', 'ref'])
def test_eval_matches_victor_tpu(sampling_cfg, joint_cfg, tmp_path, capsys,
                                 which, args):
    path = _write(tmp_path, sampling_cfg if which == 'single' else joint_cfg)
    jmain(['eval', path] + args)
    want = _json(capsys)
    tmain(['eval', path, '--device', 'cpu'] + args)
    got = _json(capsys)
    assert set(got) == set(want)
    assert got['params'] == want['params']
    for k in ('log_likelihood', 'chi2'):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9)
    if which == 'joint':
        assert got['n_quantiles'] == want['n_quantiles'] == 2


def test_chip_smoke_eval_goldens(sampling_cfg, tmp_path, capsys):
    """chip_smoke.py holds the card's `eval` to victor_tpu's values on
    configs/boss_sampling_config.yaml at the golden point and at the
    config's ref point; this recomputes them and compares with the
    literals in the script."""
    (goldens,) = _chip_smoke_literals('EVAL_GOLDENS')
    path = _write(tmp_path, sampling_cfg)
    for name, args in (('golden', GOLDEN_ARGS), ('ref', [])):
        jmain(['eval', path] + args)
        out = _json(capsys)
        np.testing.assert_allclose([out['chi2'], out['log_likelihood']],
                                   goldens[name], rtol=1e-12)
    assert abs(goldens['golden'][0] - 65.01) < 0.01
    assert abs(goldens['golden'][1] - 284.76) < 0.01


def test_chip_smoke_quadrature_block(sampling_cfg):
    """chip_smoke.py holds its MH posterior to the quadrature moments of
    tests/test_optimize.py, so it must sample the posterior that the
    quadrature integrates: BLOCK_4P with the sigma_v prior of
    configs/boss_sampling_config.yaml, which ends where the grid of
    tools/validate_posterior.py ends; every other axis of the grid lies
    inside the block's priors, more than 3.5 sigma from the mean."""
    block, mean, std = _chip_smoke_literals('QUAD_BLOCK', 'QUAD_MEAN',
                                            'QUAD_STD')
    opt = _literals('tests/test_optimize.py', 'BLOCK_4P', 'QUAD_MEAN',
                    'QUAD_STD')
    assert mean == opt['QUAD_MEAN'] and std == opt['QUAD_STD']
    assert block['sigma_v']['prior'] == \
        sampling_cfg['params']['sigma_v']['prior']
    assert {k: v for k, v in block.items() if k != 'sigma_v'} == \
        {k: v for k, v in opt['BLOCK_4P'].items() if k != 'sigma_v'}
    assert block['sigma_v']['ref'] == opt['BLOCK_4P']['sigma_v']['ref']
    tool = ast.parse(open(os.path.join(
        REPO, 'tools', 'validate_posterior.py')).read())
    axes = [[ast.literal_eval(a) for a in node.args[:2]]
            for node in ast.walk(tool) if isinstance(node, ast.Call)
            and getattr(node.func, 'attr', None) == 'linspace']
    assert len(axes) == 4
    for name, (lo, hi) in zip(('fsigma8', 'beta', 'sigma_v', 'epsilon'),
                              axes):
        p = block[name]['prior']
        assert p['min'] <= lo and hi <= p['max'], name
        assert (mean[name] - lo) / std[name] > 3.5, name
        if name == 'sigma_v':
            assert hi == p['max']
        else:
            assert (hi - mean[name]) / std[name] > 3.5, name


def _mh_cfg(sampling_cfg):
    cfg = copy.deepcopy(sampling_cfg)
    cfg['params'] = {
        'fsigma8': {'prior': {'dist': 'uniform', 'min': 0.05, 'max': 1.5},
                    'ref': {'dist': 'norm', 'loc': 0.47, 'scale': 0.02},
                    'proposal': 0.02},
        'beta': 0.37, 'sigma_v': 380.0, 'epsilon': 1.0,
        'aperp': {'value': 'lambda fsigma8, epsilon: '
                           'fsigma8 * epsilon**(1/3)'},
    }
    cfg['sampler'] = {'kind': 'mh', 'n_chains': 2}
    return cfg


def test_run_mh_writes_the_same_files(sampling_cfg, tmp_path, capsys):
    path = _write(tmp_path, _mh_cfg(sampling_cfg))
    outs = {}
    for name, main, extra in (('j', jmain, []), ('t', tmain,
                                                 ['--device', 'cpu'])):
        main(['run', path, '--warmup', '4', '--samples', '4', '--seed', '3',
              '--output', str(tmp_path / name / 'mh')] + extra)
        outs[name] = _json(capsys)
    assert sorted(os.listdir(tmp_path / 't')) == \
        sorted(os.listdir(tmp_path / 'j'))
    assert {'mh.1.txt', 'mh.2.txt', 'mh.paramnames', 'mh.ranges',
            'mh.covmat', 'mh.progress', 'mh.input.yaml'} == \
        set(os.listdir(tmp_path / 't'))
    for fn in ('mh.paramnames', 'mh.ranges', 'mh.input.yaml'):
        assert (tmp_path / 't' / fn).read_bytes() == \
            (tmp_path / 'j' / fn).read_bytes(), fn
    got, want = outs['t'], outs['j']
    assert set(got) == set(want) and got['sampler'] == 'mh'
    assert got['n_samples'] == want['n_samples'] == 4
    assert set(got['summary']) == set(want['summary']) == {'fsigma8'}
    table = np.loadtxt(tmp_path / 't' / 'mh.1.txt')
    assert table.shape == (4, 5) and np.isfinite(table).all()


def test_run_ensemble_and_cobaya_nesting(sampling_cfg, tmp_path, capsys):
    cfg = _mh_cfg(sampling_cfg)
    cfg['sampler'] = {'n_walkers': 8, 'max_steps': 4, 'check_every': 2,
                      'rhat_stop': 0.0}
    tmain(['run', _write(tmp_path, cfg), '--sampler', 'ensemble',
           '--device', 'cpu'])
    out = _json(capsys)
    assert out['sampler'] == 'ensemble' and out['n_steps'] == 4
    assert set(out['summary']) == {'fsigma8'}
    # cobaya's mcmc: nesting is adaptive random-walk Metropolis, with its
    # draw cap and Rminus1_stop
    cfg['sampler'] = {'mcmc': {'max_samples': 6, 'Rminus1_stop': 0.5},
                      'n_chains': 2}
    tmain(['run', _write(tmp_path, cfg, 'mcmc.yaml'), '--warmup', '2',
           '--device', 'cpu'])
    out = _json(capsys)
    assert out['sampler'] == 'mh' and out['n_samples'] <= 6


@pytest.mark.parametrize('how', ['smc', 'ns', 'polychord'])
def test_unported_samplers_exit(sampling_cfg, narrow, tmp_path, capsys,
                                monkeypatch, how):
    """smc, ns and cobaya's polychord: nesting used to exit here as not
    ported; they now run through `run` and print victor_tpu's JSON keys
    (posterior_predictive_p included) with the GetDist files, and the
    nesting maps nlive -> n_live, precision_criterion -> dlogz and
    num_repeats -> n_steps."""
    import victor_tpu_torch.sampling as tsampling
    cfg = copy.deepcopy(sampling_cfg)
    root = str(tmp_path / 'out' / how)
    if how == 'polychord':
        cfg['sampler'] = {'polychord': {'nlive': 16, 'precision_criterion':
                                        0.5, 'num_repeats': 1}}
        args = []
    elif how == 'smc':
        args = ['--sampler', 'smc', '--particles', '16', '--moves', '1']
    else:
        args = ['--sampler', 'ns', '--live', '16', '--ns-steps', '1',
                '--dlogz', '0.5']
    seen = {}
    real = tsampling.run_nested

    def spy(bundle, block, **kw):
        seen.update(kw)
        return real(bundle, block, **kw)
    monkeypatch.setattr(tsampling, 'run_nested', spy)
    tmain(['run', _write(tmp_path, cfg), '--seed', '2', '--output', root,
           '--device', 'cpu'] + args)
    out = _json(capsys)
    keys = {'sampler', 'log_evidence', 'log_evidence_se', 'elapsed_s',
            'summary', 'posterior_predictive_p'}
    if how == 'smc':
        keys |= {'n_particles', 'n_stages', 'log_evidence_se_clt'}
    else:
        keys |= {'n_live', 'n_iterations', 'n_likelihood_evals',
                 'information_nats', 'posterior_ess'}
        assert (seen['n_live'], seen['n_steps'], seen['dlogz']) == \
            (16, 1, 0.5)
        assert out['n_likelihood_evals'] == 16 + 4 * out['n_iterations']
    assert set(out) == keys and out['sampler'] == ('smc' if how == 'smc'
                                                  else 'ns')
    assert np.isfinite(out['log_evidence'])
    assert 0.0 <= out['posterior_predictive_p'] <= 1.0
    assert set(out['summary']) == set(cfg['params'])
    for ext in ('1.txt', 'paramnames', 'ranges', 'covmat', 'input.yaml'):
        assert os.path.isfile(f'{root}.{ext}'), ext


def test_run_smc_json_matches_victor_tpu(sampling_cfg, narrow, tmp_path,
                                         capsys, monkeypatch):
    """victor_tpu's `run --sampler smc` printing the port's result gives the
    port's JSON byte for byte: the same keys, rounding and p-value."""
    import victor_tpu.sampling as jsampling
    import victor_tpu_torch.sampling as tsampling
    path = _write(tmp_path, sampling_cfg)
    results = []
    real = tsampling.run_smc
    monkeypatch.setattr(tsampling, 'run_smc', lambda *a, **kw: results.append(
        real(*a, **kw)) or results[-1])
    args = ['run', path, '--sampler', 'smc', '--particles', '16', '--moves',
            '1']
    tmain(args + ['--device', 'cpu'])
    got = capsys.readouterr().out
    monkeypatch.setattr(jsampling, 'run_smc', lambda *a, **kw: results[0])
    jmain(args)
    assert capsys.readouterr().out == got


def test_bench_output(sampling_cfg, tmp_path, capsys):
    tmain(['bench', _write(tmp_path, sampling_cfg), '--batch', '6',
           '--reps', '1', '--chunk', '4', '--device', 'cpu'])
    out = _json(capsys)
    assert set(out) == {'evals_per_sec', 'ms_per_batch', 'batch',
                        'lnlike_tail'}
    assert out['batch'] == 6 and np.isfinite(out['lnlike_tail'])


def test_port_logs_under_its_own_namespace(caplog):
    """The port's loggers hang under `victor_tpu_torch`, apart from
    victor_tpu's, so a log line names the package that wrote it; records
    still reach the root logger's handlers (here pytest's), and after
    get_logger has configured the package's console handler the port's
    other module loggers keep propagating."""
    import logging

    from victor_tpu_torch.utils import get_logger
    log = get_logger('sampling')
    assert log.name == 'victor_tpu_torch.sampling'
    assert log.parent.name == 'victor_tpu_torch' and log.parent.handlers
    with caplog.at_level('INFO', logger='victor_tpu_torch'):
        log.info('sampler line')
        logging.getLogger('victor_tpu_torch.theory').warning('theory line')
    assert [(r.name, r.getMessage()) for r in caplog.records] == [
        ('victor_tpu_torch.sampling', 'sampler line'),
        ('victor_tpu_torch.theory', 'theory line')]


def test_default_device_is_the_card(sampling_cfg, tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    path = _write(tmp_path, sampling_cfg)
    for cmd in ('eval', 'run', 'bench', 'fit', 'scan', 'forecast', 'analyze'):
        with pytest.raises(RuntimeError, match='--device cpu'):
            tmain([cmd, path])
    for argv in (['post', path, '--chains', path], ['tension', path, path],
                 ['compare', path, path]):
        with pytest.raises(RuntimeError, match='--device cpu'):
            tmain(argv)


# ---------------------------------------------------------------------------
# the optimizer commands
# ---------------------------------------------------------------------------

@pytest.fixture()
def narrow(monkeypatch):
    """Both CLIs build single-dataset tables at a narrow width (n_mu 20,
    n_v 10), the same in both packages, so that whole fits run in
    seconds."""
    import victor_tpu.__main__ as jcli
    import victor_tpu_torch.__main__ as tcli
    from victor_tpu.io import build_tables as jbuild
    from victor_tpu_torch.io import build_tables as tbuild
    monkeypatch.setattr(jcli, '_build_bundle', lambda cfg: jbuild(
        cfg['model'], cfg.get('data'), n_mu=20, n_v=10))
    monkeypatch.setattr(tcli, '_build_bundle', lambda cfg, device: tbuild(
        cfg['model'], cfg.get('data'), n_mu=20, n_v=10, device=device))


FIT_ARGS = ['--starts', '4', '--adam-steps', '120']


def _check_fit_json(got, want):
    """A fit's JSON against victor_tpu's at its printed rounding; the
    elapsed time and the gradient norm (both stationary) aside."""
    assert set(got) == set(want)
    for k in ('chi2', 'p_value', 'log_likelihood', 'log_posterior'):
        assert abs(got[k] - want[k]) <= 1.5e-4, k
    assert got['ndof'] == want['ndof'] == 56
    assert got['n_converged'] == want['n_converged'] == 4
    for k in ('best_fit', 'std_laplace'):
        assert list(got[k]) == list(want[k])
        np.testing.assert_allclose(list(got[k].values()),
                                   list(want[k].values()), rtol=1e-6,
                                   atol=2e-6, err_msg=k)
    assert got['grad_norm'] < 1e-6 and want['grad_norm'] < 1e-6
    assert abs(got['log_evidence_laplace'] -
               want['log_evidence_laplace']) < 3e-3


def test_fit_matches_victor_tpu(sampling_cfg, narrow, tmp_path, capsys):
    """`fit --bootstrap 4 --covmat-out` (4 starts, 120 Adam steps): every
    key of victor_tpu's JSON with its value at the printed rounding (the
    optimum does not depend on the starts), the bootstrap of the same mocks,
    and the covmat files."""
    path = _write(tmp_path, sampling_cfg)
    args = FIT_ARGS + ['--bootstrap', '4']
    jmain(['fit', path, '--covmat-out', str(tmp_path / 'j.covmat')] + args)
    want = _json(capsys)
    tmain(['fit', path, '--covmat-out', str(tmp_path / 't.covmat'),
           '--device', 'cpu'] + args)
    got = _json(capsys)
    boot_g, boot_w = got.pop('bootstrap'), want.pop('bootstrap')
    _check_fit_json({k: v for k, v in got.items() if k != 'covmat_file'},
                    {k: v for k, v in want.items() if k != 'covmat_file'})
    assert got['covmat_file'] == str(tmp_path / 't.covmat')
    assert set(boot_g) == set(boot_w) and boot_g['n_boot'] == 4
    for k in ('best_fit_debiased', 'bias', 'std_bootstrap'):
        np.testing.assert_allclose(list(boot_g[k].values()),
                                   list(boot_w[k].values()), rtol=1e-4,
                                   atol=2e-6, err_msg=k)
    from victor_tpu_torch.sampling.chains import read_covmat
    names = list(got['best_fit'])
    np.testing.assert_allclose(read_covmat(str(tmp_path / 't.covmat'), names),
                               read_covmat(str(tmp_path / 'j.covmat'), names),
                               rtol=1e-6)


def test_run_minimize_nesting_runs_fit(sampling_cfg, narrow, tmp_path,
                                       capsys):
    """cobaya's `minimize:` nesting of `run` dispatches to `fit` with its
    n_starts and adam_steps, and an output root writes <root>.covmat and
    <root>.input.yaml; the JSON is victor_tpu's `fit` JSON. (victor_tpu's
    own `run` with minimize: stops at its missing `bootstrap` argument,
    victor_tpu/__main__.py:618, ROADMAP Queue 3.)"""
    path = _write(tmp_path, sampling_cfg)
    jmain(['fit', path] + FIT_ARGS)
    want = _json(capsys)
    cfg = copy.deepcopy(sampling_cfg)
    root = str(tmp_path / 'out' / 'map')
    cfg['sampler'] = {'minimize': {'n_starts': 4, 'adam_steps': 120},
                      'output': root}
    tmain(['run', _write(tmp_path, cfg, 'min.yaml'), '--device', 'cpu'])
    got = _json(capsys)
    assert got.pop('covmat_file') == root + '.covmat'
    _check_fit_json(got, want)
    assert os.path.isfile(root + '.covmat')
    assert os.path.isfile(root + '.input.yaml')


def test_scan_matches_victor_tpu(sampling_cfg, narrow, tmp_path, capsys):
    """`scan --param fsigma8 --ngrid 5 --nsigma 3` (the default 32-start MAP
    inside): victor_tpu's keys, its grid, profile chi2 and intervals at the
    printed rounding. At this narrow width the +4 sigma point's nuisance
    descent can end on either side of one of the likelihood's beta-grid
    jumps (ROADMAP Queue 3): MAPs 1e-8 sigma apart moved it by 1.3e-3 in
    chi2, while from one MAP the packages agree within 2e-10; hence 3
    sigma. At full width all nine points of the default grid agree within
    6e-9 (chip_smoke.py's SCAN_GOLDENS)."""
    path = _write(tmp_path, sampling_cfg)
    args = ['--param', 'fsigma8', '--ngrid', '5', '--nsigma', '3']
    jmain(['scan', path] + args)
    want = _json(capsys)
    tmain(['scan', path, '--device', 'cpu'] + args)
    got = _json(capsys)
    assert set(got) == set(want) and got['scan'] == want['scan']
    for k in ('grid', 'chi2_profile', 'delta_chi2', 'interval_68',
              'interval_95'):
        np.testing.assert_allclose(np.array(got[k], dtype=float),
                                   np.array(want[k], dtype=float), rtol=0,
                                   atol=1.5e-4, err_msg=k)
    np.testing.assert_allclose(list(got['best_fit'].values()),
                               list(want['best_fit'].values()), rtol=1e-6)


def test_forecast_matches_victor_tpu(sampling_cfg, narrow, tmp_path, capsys):
    """`forecast` at the ref point and with --param overrides (one outside
    the params block, echoed back): victor_tpu's JSON at its rounding; a
    derived name is refused before the tables are built."""
    path = _write(tmp_path, sampling_cfg)
    for args in ([], ['--param', 'fsigma8=0.5', '--param', 'bias=2.0']):
        jmain(['forecast', path] + args)
        want = _json(capsys)
        tmain(['forecast', path, '--device', 'cpu'] + args)
        got = _json(capsys)
        assert set(got) == set(want)
        for k in ('fiducial', 'overrides', 'correlation'):
            assert got.get(k) == want.get(k), k
        np.testing.assert_allclose(list(got['sigma_fisher'].values()),
                                   list(want['sigma_fisher'].values()),
                                   rtol=1e-5, atol=1e-6)
    cfg = copy.deepcopy(sampling_cfg)
    cfg['params']['aperp'] = {'value': 'lambda epsilon: epsilon ** 0.5'}
    with pytest.raises(SystemExit, match='derived'):
        tmain(['forecast', _write(tmp_path, cfg, 'derived.yaml'),
               '--param', 'aperp=1.0', '--device', 'cpu'])


# ---------------------------------------------------------------------------
# the evidence commands: analyze, post, tension, compare
# ---------------------------------------------------------------------------

def _capture(monkeypatch, module, name):
    """Record the results of `module.name` while a CLI command runs."""
    results = []
    real = getattr(module, name)

    def wrapped(*args, **kw):
        results.append(real(*args, **kw))
        return results[-1]
    monkeypatch.setattr(module, name, wrapped)
    return results


def _replay(monkeypatch, module, name, results):
    """`module.name` returns `results` in turn (victor_tpu's CLI printing
    the port's results)."""
    queue = list(results)
    monkeypatch.setattr(module, name, lambda *a, **kw: queue.pop(0))


def test_post_matches_victor_tpu(sampling_cfg, narrow, tmp_path, capsys):
    """`post --set data.likelihood.form=gaussian` on the chains of a short
    SMC run: the port's JSON against victor_tpu's on the same chains —
    the same keys, Delta ln Z, ESS and moments at the printed rounding —
    and the reweighted chain files."""
    from victor_tpu_torch.sampling.chains import read_getdist
    path = _write(tmp_path, sampling_cfg)
    root = str(tmp_path / 'c' / 'smc')
    tmain(['run', path, '--sampler', 'smc', '--particles', '24', '--moves',
           '1', '--seed', '4', '--output', root, '--device', 'cpu'])
    capsys.readouterr()
    outs = {}
    for name, main, extra in (('j', jmain, []),
                              ('t', tmain, ['--device', 'cpu'])):
        main(['post', path, '--chains', root, '--set',
              'data.likelihood.form=gaussian', '--chunk', '8',
              '--output', str(tmp_path / name / 'post')] + extra)
        outs[name] = _json(capsys)
    got, want = outs['t'], outs['j']
    assert set(got) == set(want) and got['n_particles'] == 24
    for k in ('delta_logz', 'delta_logz_se', 'ess', 'efficiency'):
        assert abs(got[k] - want[k]) <= 1e-4, k
    assert got['params_old'] == want['params_old']
    for name in got['params_new']:
        for m in ('mean', 'std'):
            assert abs(got['params_new'][name][m] -
                       want['params_new'][name][m]) <= 2e-6 * max(
                1.0, abs(want['params_new'][name][m]))
    names, w, mlnp, _ = read_getdist(str(tmp_path / 't' / 'post'))
    assert names[-1] == 'chi2_ccf_correct' and w.shape == (24,)
    assert w.mean() == pytest.approx(1.0, abs=1e-6)
    with pytest.raises(SystemExit, match='modified target'):
        tmain(['post', path, '--chains', root, '--device', 'cpu'])


def test_tension_json_matches_victor_tpu(sampling_cfg, narrow, tmp_path,
                                         capsys, monkeypatch):
    """`tension cfg cfg` (a dataset against itself): concordance, ln R > 0,
    and victor_tpu's CLI printing the port's TensionResult gives the port's
    JSON byte for byte; a second config with another params block is
    refused."""
    import victor_tpu.sampling.tension as jtension
    import victor_tpu_torch.sampling.tension as ttension
    cfg = copy.deepcopy(sampling_cfg)
    cfg['params'] = {k: cfg['params'][k] for k in ('fsigma8', 'beta')}
    cfg['params'].update(sigma_v=380.0, epsilon=1.0)
    path = _write(tmp_path, cfg)
    results = _capture(monkeypatch, ttension, 'run_tension')
    args = ['tension', path, path, '--particles', '128', '--moves', '2',
            '--seed', '3']
    tmain(args + ['--device', 'cpu'])
    got = capsys.readouterr().out
    out = json.loads(got)
    assert out['verdict'] == 'concordance' and out['log_evidence_ratio'] > 0
    assert out['shared_params'] == ['beta', 'fsigma8']
    _replay(monkeypatch, jtension, 'run_tension', results)
    jmain(args)
    assert capsys.readouterr().out == got
    other = copy.deepcopy(cfg)
    other['params']['epsilon'] = 1.05
    with pytest.raises(SystemExit, match='share ONE params'):
        tmain(['tension', path, _write(tmp_path, other, 'b.yaml'),
               '--device', 'cpu'])


def test_compare_json_matches_victor_tpu(sampling_cfg, narrow, tmp_path,
                                         capsys, monkeypatch):
    """`compare cfg cfg --set-b model.rsd_model=kaiser`: the runs keyed 'a'
    and 'b' with their overrides, and victor_tpu's CLI printing the port's
    two SMC results gives the port's JSON byte for byte."""
    import victor_tpu.sampling as jsampling
    import victor_tpu_torch.sampling as tsampling
    path = _write(tmp_path, sampling_cfg)
    results = _capture(monkeypatch, tsampling, 'run_smc')
    args = ['compare', path, path, '--set-b', 'model.rsd_model=kaiser',
            '--particles', '16', '--moves', '1', '--seed', '5']
    tmain(args + ['--device', 'cpu'])
    got = capsys.readouterr().out
    out = json.loads(got)
    assert out['a']['set'] == [] and \
        out['b']['set'] == ['model.rsd_model=kaiser']
    assert out['favored'] in ('a', 'b') and len(results) == 2
    _replay(monkeypatch, jsampling, 'run_smc', results)
    jmain(args)
    assert capsys.readouterr().out == got


def test_analyze_no_plots_writes_the_report(sampling_cfg, narrow, tmp_path,
                                            capsys, monkeypatch):
    """`analyze --no-plots`: report.md with victor_tpu's sections (victor_tpu's
    analyze, given the port's MAP and SMC results, writes the same headings
    and the same JSON apart from the times), input.yaml, GetDist chains
    that read back, and the covmat."""
    import victor_tpu.sampling as jsampling
    import victor_tpu.sampling.optimize as joptimize
    import victor_tpu_torch.sampling as tsampling
    import victor_tpu_torch.sampling.optimize as toptimize
    from victor_tpu_torch.sampling.chains import read_covmat, read_getdist
    path = _write(tmp_path, sampling_cfg)
    maps = _capture(monkeypatch, toptimize, 'find_map')
    smcs = _capture(monkeypatch, tsampling, 'run_smc')
    args = ['analyze', path, '--no-plots', '--starts', '2', '--adam-steps',
            '20', '--particles', '24', '--moves', '1']
    tmain(args + ['--output', str(tmp_path / 't'), '--device', 'cpu'])
    got = _json(capsys)
    files = set(os.listdir(tmp_path / 't'))
    assert {'report.md', 'input.yaml', 'chains.1.txt', 'chains.paramnames',
            'chains.ranges', 'chains.covmat'} <= files
    names, w, _, samples = read_getdist(str(tmp_path / 't' / 'chains'))
    # the config's YAML round trip sorts the params block
    assert names == sorted(sampling_cfg['params']) + ['chi2_ccf_correct']
    assert samples.shape == (24, 5) and np.isfinite(samples).all()
    assert read_covmat(str(tmp_path / 't' / 'chains.covmat'),
                       names[:4]).shape == (4, 4)
    _replay(monkeypatch, joptimize, 'find_map', maps)
    _replay(monkeypatch, jsampling, 'run_smc', smcs)
    jmain(args + ['--output', str(tmp_path / 'j')])
    want = _json(capsys)
    got.pop('report'), want.pop('report')
    got.pop('elapsed_s'), want.pop('elapsed_s')
    assert got == want

    def headings(d):
        # the sections and the table, the wall times aside
        import re
        with open(tmp_path / d / 'report.md') as f:
            return [re.sub(r'[0-9.]+ s\)', 's)', ln)
                    for ln in f.read().splitlines()
                    if ln.startswith('#') or ln.startswith('|')]
    assert headings('t')[1:] == headings('j')[1:]
    assert headings('t')[0].replace('victor_tpu_torch', 'victor_tpu') == \
        headings('j')[0]


def test_analyze_writes_the_figures(sampling_cfg, narrow, tmp_path, capsys,
                                    monkeypatch):
    """`analyze` without --no-plots draws corner.png and multipoles.png
    (non-empty PNGs) and lists them as victor_tpu's report does: its
    analyze, given the port's MAP and SMC results, writes the same Figures
    section and the same `figures` JSON (its data-vs-model panels stubbed:
    they would plot the port's MAP through victor_tpu's CCFFit)."""
    import victor_tpu.__main__ as jcli
    import victor_tpu.sampling as jsampling
    import victor_tpu.sampling.optimize as joptimize
    import victor_tpu_torch.sampling as tsampling
    import victor_tpu_torch.sampling.optimize as toptimize
    path = _write(tmp_path, sampling_cfg)
    maps = _capture(monkeypatch, toptimize, 'find_map')
    smcs = _capture(monkeypatch, tsampling, 'run_smc')
    args = ['analyze', path, '--starts', '2', '--adam-steps', '20',
            '--particles', '24', '--moves', '1']
    tmain(args + ['--output', str(tmp_path / 't'), '--device', 'cpu'])
    got = _json(capsys)
    for name in ('corner.png', 'multipoles.png'):
        with open(tmp_path / 't' / name, 'rb') as f:
            assert f.read(8) == b'\x89PNG\r\n\x1a\n', name
        assert os.path.getsize(tmp_path / 't' / name) > 10_000, name
    _replay(monkeypatch, joptimize, 'find_map', maps)
    _replay(monkeypatch, jsampling, 'run_smc', smcs)
    monkeypatch.setattr(jcli, '_plot_map_multipoles',
                        lambda cfg, bundle, mres, out: open(out, 'wb').close())
    jmain(args + ['--output', str(tmp_path / 'j')])
    want = _json(capsys)
    assert [os.path.relpath(f, tmp_path / 't') for f in got['figures']] == \
        [os.path.relpath(f, tmp_path / 'j') for f in want['figures']] == \
        ['corner.png', 'multipoles.png']

    def figures(d):
        with open(tmp_path / d / 'report.md') as f:
            text = f.read()
        return text[text.index('## Figures'):text.index('## Notes')]
    assert figures('t') == figures('j')
    assert '![data vs best-fit model multipoles](multipoles.png)' in \
        figures('t')
