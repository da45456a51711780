"""`python -m victor_tpu_torch` (run, eval, bench) against victor_tpu's CLI.

The port's `main([...,'--device', 'cpu'])` and victor_tpu's `main([...])`
run on the same configs in one process; their JSON and their chain files
are compared. Also recomputes the eval goldens that chip_smoke.py holds the
card to.
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


@pytest.mark.parametrize('how', ['smc', 'ns', 'minimize', 'polychord'])
def test_unported_samplers_exit(sampling_cfg, tmp_path, how):
    cfg = copy.deepcopy(sampling_cfg)
    args = []
    if how == 'minimize':
        cfg['sampler'] = {'minimize': {}}
    elif how == 'polychord':
        cfg['sampler'] = {'polychord': {'nlive': 100}}
    else:
        args = ['--sampler', how]
    with pytest.raises(SystemExit, match='not ported yet'):
        tmain(['run', _write(tmp_path, cfg)] + args + ['--device', 'cpu'])


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
    for cmd in ('eval', 'run', 'bench'):
        with pytest.raises(RuntimeError, match='--device cpu'):
            tmain([cmd, _write(tmp_path, sampling_cfg)])
