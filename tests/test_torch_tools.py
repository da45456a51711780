"""The port's validation tools (`tools/*_torch.py`) against the JAX tools
they port.

Every constant the tools copy is held equal to the JAX tool's; the
quadrature's likelihood and arithmetic, the fast-mode acceptance rule, the
coverage tool's mock vectors and joint tables and the tension probe's data
vectors are held against victor_tpu in f64 (tables at a narrow width, n_mu
20 and n_v 10, where a whole width is not needed); each tool's `main` runs
on the CPU at small sizes, and exits 2 when asked for a card that is not
there.
"""

import ast
import copy
import dataclasses
import functools
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, 'tools'))

import coverage_test as jcov  # noqa: E402
import coverage_test_torch as tcov  # noqa: E402
import tension_injection_probe as jten  # noqa: E402
import tension_injection_probe_torch as tten  # noqa: E402
import validate_dispersion_fast as jdisp  # noqa: E402
import validate_dispersion_fast_torch as tdisp  # noqa: E402
import validate_posterior_torch as tpost  # noqa: E402
from victor_tpu_torch.io.tables import bundle_from_arrays, tables_to_arrays  # noqa: E402
from victor_tpu_torch.io import build_tables as tbuild  # noqa: E402

torch.set_num_threads(1)
NARROW = {'n_mu': 20, 'n_v': 10}
NAMES = ['fsigma8', 'beta', 'sigma_v', 'epsilon']


def _tree(name):
    with open(os.path.join(REPO, 'tools', name)) as f:
        return ast.parse(f.read())


def _main_def(tree):
    return next(node for node in tree.body
                if isinstance(node, ast.FunctionDef) and node.name == 'main')


def _config(name):
    import yaml
    with open(os.path.join(REPO, 'configs', name)) as f:
        cfg = yaml.safe_load(f)
    cfg['model']['dir'] = cfg['data']['dir'] = REPO
    return cfg


def _pair(name='boss_config.yaml'):
    """victor_tpu's bundle of configs/`name` at the narrow width and the
    port's on the same tables, on the CPU in f64."""
    from victor_tpu.io import build_tables as jbuild
    cfg = _config(name)
    jb = jbuild(copy.deepcopy(cfg['model']), copy.deepcopy(cfg['data']),
                **NARROW)
    tb = bundle_from_arrays(tables_to_arrays(jb.tables),
                            dataclasses.asdict(jb.spec),
                            dataclasses.asdict(jb.theory_opts),
                            dataclasses.asdict(jb.fit_opts), device='cpu')
    return jb, tb


@pytest.fixture()
def narrow(monkeypatch):
    """Every tool builds its single-dataset tables at the narrow width."""
    for tool in (tpost, tdisp, tcov, tten):
        monkeypatch.setattr(tool, 'build_tables',
                            functools.partial(tbuild, **NARROW))


# ---------------------------------------------------------------------------
# the copied constants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('name', [
    'FIDUCIAL', 'PARAMS_BLOCK', 'SBC_BLOCK', 'JOINT_FIDUCIAL',
    'JOINT_PARAMS_BLOCK', 'SBC_BLOCK_JOINT', 'ESM_FIDUCIAL', 'SBC_BLOCK_ESM'])
def test_coverage_constants_equal_original(name):
    assert getattr(tcov, name) == getattr(jcov, name)


def test_run_defaults_equal_original():
    """Every numeric core keeps its original's keyword defaults (the
    port's `device` aside)."""
    import inspect
    for fn in ('run_coverage', 'run_coverage_smc', 'run_coverage_ns',
               'run_coverage_mh', 'run_coverage_ensemble', 'run_sbc',
               'build_joint_boss_bundle'):
        want = {k: v.default for k, v in
                inspect.signature(getattr(jcov, fn)).parameters.items()}
        got = {k: v.default for k, v in
               inspect.signature(getattr(tcov, fn)).parameters.items()
               if k != 'device'}
        assert got == want, fn


def test_tension_constants_equal_original():
    assert tten.SIGMA_FSIGMA8 == jten.SIGMA_FSIGMA8
    fid = [ast.literal_eval(node.value)
           for node in ast.walk(_main_def(_tree('tension_injection_probe.py')))
           if isinstance(node, ast.Assign)
           and getattr(node.targets[0], 'id', None) == 'fid']
    assert fid == [tten.FIDUCIAL]


def test_dispersion_constants_equal_original():
    assert sorted(tdisp.OPTS) == sorted(jdisp.OPTS)
    for model in jdisp.OPTS:
        for mode in ('exact', 'fast'):
            assert tdisp.OPTS[model](mode) == jdisp.OPTS[model](mode)
    call = next(node for node in ast.walk(_tree('validate_dispersion_fast.py'))
                if isinstance(node, ast.Call)
                and getattr(node.func, 'id', None) == 'run_smc')
    kw = {k.arg: ast.literal_eval(k.value) for k in call.keywords
          if k.arg in ('n_particles', 'n_moves')}
    assert kw == {'n_particles': tdisp.N_PARTICLES,
                  'n_moves': tdisp.N_MOVES}


def test_quadrature_axes_equal_original():
    tree = _tree('validate_posterior.py')
    axes = [[ast.literal_eval(a) for a in node.args[:2]]
            for node in ast.walk(tree) if isinstance(node, ast.Call)
            and getattr(node.func, 'attr', None) == 'linspace']
    for n in (3, 36):
        got = tpost.quadrature_axes(n)
        assert [[ax[0], ax[-1]] for ax in got] == axes
        assert all(len(ax) == n for ax in got)
    call = next(node for node in ast.walk(tree) if isinstance(node, ast.Call)
                and getattr(node.func, 'id', None) == 'make_batched_loglike')
    assert {k.arg: ast.literal_eval(k.value) for k in call.keywords} == \
        {'chunk': tpost.CHUNK, 'gradient_free': False}
    assert tpost.NAMES == NAMES


# ---------------------------------------------------------------------------
# the quadrature against victor_tpu
# ---------------------------------------------------------------------------

def original_quadrature(lnl, axes, cfg):
    """tools/validate_posterior.py's arithmetic after the likelihood
    evaluations (its main from `w = np.exp(...)` on), run on `lnl`: its
    mean, std and logZ, and the lines it prints."""
    body = _main_def(_tree('validate_posterior.py')).body
    start = next(i for i, node in enumerate(body)
                 if isinstance(node, ast.Assign)
                 and getattr(node.targets[0], 'id', None) == 'w')
    code = compile(ast.Module(body=body[start:], type_ignores=[]),
                   'validate_posterior.py', 'exec')
    lines = []
    n = len(axes[0])
    ns = {'np': np, 'lnl': lnl, 'axes': axes, 'n': n, 'cfg': cfg,
          'names': NAMES, 'grid': tpost.quadrature_grid(axes),
          'print': lambda *a: lines.append(' '.join(map(str, a)))}
    exec(code, ns)
    return ns['mean'], ns['std'], ns.get('logz'), lines


def test_grid_quadrature_matches_victor_tpu():
    """The port's lnL on a 3^4 grid against victor_tpu's
    make_batched_loglike(..., chunk=128, gradient_free=False) in f64
    (1e-9), and grid_quadrature against the JAX tool's own arithmetic on
    victor_tpu's lnL (1e-9), printed lines equal."""
    import jax.numpy as jnp
    from victor_tpu.likelihood.batched import make_batched_loglike
    from victor_tpu_torch.sampling.priors import ParamSpace
    jb, tb = _pair('boss_sampling_config.yaml')
    cfg = _config('boss_sampling_config.yaml')
    axes = tpost.quadrature_axes(3)
    grid = tpost.quadrature_grid(axes)
    got = tpost.evaluate_grid(tpost.grid_loglike(tb, 'cpu'), grid, 3)
    want = np.asarray(make_batched_loglike(
        jb, NAMES, chunk=128, gradient_free=False)(
            jnp.asarray(grid, dtype=jnp.float64))[0])
    np.testing.assert_allclose(got, want, rtol=1e-9)
    mean, std, edge, logz = tpost.grid_quadrature(
        got, axes, ParamSpace(cfg['params']))
    jmean, jstd, jlogz, lines = original_quadrature(want, axes, cfg)
    np.testing.assert_allclose(mean, jmean, rtol=1e-9)
    np.testing.assert_allclose(std, jstd, rtol=1e-9)
    assert logz == pytest.approx(jlogz, rel=1e-9)
    assert tpost.report_lines(mean, std, edge, logz) == lines


def test_grid_quadrature_without_uniform_priors_has_no_logz():
    from victor_tpu_torch.sampling.priors import ParamSpace
    axes = tpost.quadrature_axes(3)
    lnl = -0.5 * ((tpost.quadrature_grid(axes) - [0.6, 0.36, 420.0, 1.01])
                  ** 2 / np.array([0.05, 0.01, 40.0, 0.01]) ** 2).sum(1)
    block = copy.deepcopy(tcov.SBC_BLOCK)
    *_, logz = tpost.grid_quadrature(lnl, axes, ParamSpace(block))
    assert logz is None


# ---------------------------------------------------------------------------
# the fast-mode acceptance against the JAX tool's rule
# ---------------------------------------------------------------------------

def _summaries(shift_mean=0.0, shift_std=0.0, seed=0):
    base = {'fsigma8': (0.5725, 0.0542), 'beta': (0.3669, 0.0104),
            'sigma_v': (417.97, 44.30), 'epsilon': (1.0091, 0.0106)}
    out = {}
    for i, (name, (m, s)) in enumerate(base.items()):
        wobble = 0.003 * s * ((seed + i) % 3 - 1)
        out[name] = {'mean': m + shift_mean * s + wobble,
                     'std': s * (1 + shift_std) + 0.1 * wobble}
    return out


# (seeds, fast-mode shifts: mean in sigma, relative std, logZ; logz_se)
MODE_CASES = {
    'pass': (1, 0.03, 0.02, 0.05, 0.08),
    'fails_mean': (1, 0.15, 0.02, 0.05, 0.08),
    'fails_std': (1, 0.03, 0.12, 0.05, 0.08),
    'fails_logz': (1, 0.03, 0.02, 0.5, 0.08),
    'pass_3_seeds': (3, 0.05, 0.04, 0.05, 0.08),
    'fails_logz_3_seeds': (3, 0.05, 0.04, 0.9, 0.08),
}


@pytest.mark.parametrize('case', sorted(MODE_CASES))
def test_compare_modes_matches_original_rule(case, monkeypatch, capsys):
    """compare_modes on fixed synthetic per-seed summaries against the JAX
    tool's main, whose run_smc returns the same summaries: the same shifts,
    the same verdict and the same exit code, for a case that passes and for
    one that fails each of the three bounds."""
    import victor_tpu.io
    import victor_tpu.sampling
    import victor_tpu.utils.profiling
    seeds, dmean, dstd, dlogz, se = MODE_CASES[case]
    logz = {'exact': [278.95 + 0.07 * s for s in range(seeds)],
            'fast': [278.95 + dlogz + 0.11 * s for s in range(seeds)]}
    runs = {mode: {'summaries': [_summaries(*((dmean, dstd)
                                              if mode == 'fast' else (0, 0)),
                                            seed=s) for s in range(seeds)],
                   'logz': logz[mode], 'logz_se': [se] * seeds}
            for mode in ('exact', 'fast')}

    def fake_smc(bundle, block, n_particles, n_moves, seed, opts_kw):
        mode = opts_kw['streaming_eval']
        return types.SimpleNamespace(
            summary=lambda: runs[mode]['summaries'][seed],
            logz=runs[mode]['logz'][seed],
            logz_se=runs[mode]['logz_se'][seed],
            betas=np.linspace(0, 1, 8), elapsed_s=0.0)
    monkeypatch.setattr(victor_tpu.sampling, 'run_smc', fake_smc)
    monkeypatch.setattr(victor_tpu.io, 'build_tables', lambda *a, **k: None)
    monkeypatch.setattr(victor_tpu.utils.profiling,
                        'enable_persistent_cache', lambda *a, **k: None)
    monkeypatch.setattr(sys, 'argv', ['validate_dispersion_fast.py',
                                      '--model', 'streaming',
                                      '--seeds', str(seeds)])
    with pytest.raises(SystemExit) as exc:
        jdisp.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ok, shifts = tdisp.compare_modes(runs, seeds)
    assert shifts == want['shifts']
    assert ok == want['ok'] == (exc.value.code == 0)
    assert ok == case.startswith('pass')


# ---------------------------------------------------------------------------
# the coverage tool's mocks and joint tables, the tension probe's vectors
# ---------------------------------------------------------------------------

def _close(got, want, tol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


def test_mock_vectors_match_victor_tpu():
    """The first mocks of the stream (default_rng(seed)) and the data vector
    each grafts in, against victor_tpu's mock_setup and shift_datavector on
    the same tables (1e-12)."""
    import jax.numpy as jnp
    from victor_tpu.likelihood.core import multipole_datavector as jdata
    from victor_tpu.sampling.mocks import mock_setup, shift_datavector
    from victor_tpu_torch.likelihood.core import multipole_datavector
    jb, tb = _pair()
    tvec, dvec, L = mock_setup(jb, tcov.FIDUCIAL)
    ttvec, tdvec, tL = tcov._mock_setup(tb, tcov.FIDUCIAL)
    for got, want in ((ttvec, tvec), (tdvec, dvec), (tL, L)):
        _close(got, want)
    rng = np.random.default_rng(5)
    beta = 0.355
    for mock, mb in tcov.mock_bundles(tb, tcov.FIDUCIAL, 3, seed=5):
        want = tvec + L @ rng.standard_normal(len(tvec))
        _close(mock, want)
        jmb = shift_datavector(jb, want - dvec)
        _close(multipole_datavector(mb.tables, mb.spec,
                                    torch.tensor([beta], dtype=torch.float64)
                                    )[0],
               jdata(jmb.tables, jmb.spec, jnp.asarray(beta)))


def test_joint_bundle_tables_match_victor_tpu(tmp_path, monkeypatch):
    """build_joint_boss_bundle through its `.npz` cross-covariance against
    victor_tpu's through HDF5: every joint and per-quantile table
    (1e-12), the same layout."""
    import itertools
    import tempfile
    made = itertools.count()

    def mkdtemp(*args, **kw):             # inside tmp_path, not TMPDIR
        path = tmp_path / f'joint_{next(made)}'
        path.mkdir()
        return str(path)
    monkeypatch.setattr(tempfile, 'mkdtemp', mkdtemp)
    want = jcov.build_joint_boss_bundle()
    got = tcov.build_joint_boss_bundle(device='cpu')
    assert len(got.bundles) == len(want.bundles) == 2
    assert (got.ndata, got.fixed_covmat) == (want.ndata, want.fixed_covmat)
    for name in ('cov', 'icov', 'beta_cov', 'cov_logdet', 'cov_pencil'):
        if getattr(want, name) is None:
            assert getattr(got, name) is None, name
        else:
            _close(getattr(got, name), getattr(want, name))
    for b_got, b_want in zip(got.bundles, want.bundles):
        arrays = tables_to_arrays(b_want.tables)
        for name, value in tables_to_arrays(b_got.tables).items():
            if value is None or arrays[name] is None:
                assert value is None and arrays[name] is None, name
            elif isinstance(value, tuple):
                for g, w in zip(value, arrays[name]):
                    _close(g, w)
            else:
                _close(value, arrays[name])


@pytest.mark.parametrize('ns', [0.0, 6.0])
def test_tension_datavectors_match_victor_tpu(ns):
    """Datasets A and B of the tension probe, as the JAX probe makes them
    (its main's theory_vector at the shifted fiducial), 1e-12."""
    import jax.numpy as jnp
    from victor_tpu.models.ccf_theory import theory_vector
    from victor_tpu.sampling.mocks import mock_setup
    jb, tb = _pair()
    tvec, dvec, _ = mock_setup(jb, jten_fiducial())
    fid_b = dict(jten_fiducial())
    fid_b['fsigma8'] += ns * jten.SIGMA_FSIGMA8
    tvec_b = np.asarray(theory_vector(jb.tables, jb.spec, jb.theory_opts,
                                      {k: jnp.asarray(v)
                                       for k, v in fid_b.items()}))
    _, _, got_a, got_b = tten.noiseless_bundles(tb, ns)
    _close(got_a, tvec)
    _close(got_b, tvec_b)
    if ns == 0.0:
        _close(got_b, got_a)


def jten_fiducial():
    (fid,) = [ast.literal_eval(node.value)
              for node in ast.walk(_main_def(_tree(
                  'tension_injection_probe.py')))
              if isinstance(node, ast.Assign)
              and getattr(node.targets[0], 'id', None) == 'fid']
    return fid


def test_tension_verdict():
    """The probe's acceptance: the control needs ln R > 0 and a shift under
    2 sigma, the injection ln R < 0 and a shift within 1 of N / sqrt(2)."""
    def res(logr, shift):
        return types.SimpleNamespace(logr=logr, shift_nsigma=shift)
    assert tten.verdict('control', 0.0, res(8.7, 0.1))[0]
    assert not tten.verdict('control', 0.0, res(-0.1, 0.1))[0]
    assert not tten.verdict('control', 0.0, res(8.7, 2.0))[0]
    assert tten.verdict('injected', 6.0, res(-8.9, 4.98))[0]
    assert not tten.verdict('injected', 6.0, res(0.2, 4.3))[0]
    assert not tten.verdict('injected', 6.0, res(-8.9, 3.2))[0]


# ---------------------------------------------------------------------------
# the tools' mains on the CPU
# ---------------------------------------------------------------------------

def _exit_code(fn, argv):
    try:
        fn(argv)
    except SystemExit as exc:
        return exc.code
    return 0


def test_validate_posterior_main(narrow, capsys):
    assert _exit_code(tpost.main, ['--ngrid', '3', '--device', 'cpu']) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith('81 likelihood evaluations in ')
    assert lines[1].startswith('on cpu (cpu, f64, exact modes, chunk 128)')
    assert [ln.split()[0] for ln in lines[2:6]] == NAMES
    assert lines[6].startswith('log-evidence (grid quadrature, uniform '
                               'priors): logZ = ')


def test_validate_dispersion_fast_main(narrow, capsys, monkeypatch):
    """At 64 particles x 2 moves (the card runs 4096 x 8) exact and fast
    draw the same particles from one seed: the acceptance passes."""
    monkeypatch.setattr(tdisp, 'N_PARTICLES', 64)
    monkeypatch.setattr(tdisp, 'N_MOVES', 2)
    rc = _exit_code(tdisp.main, ['--model', 'streaming', '--device', 'cpu'])
    lines = [json.loads(ln) for ln in
             capsys.readouterr().out.strip().splitlines()]
    assert [(ln['mode'], ln['seed']) for ln in lines[:-1]] == \
        [('exact', 0), ('fast', 0)]
    assert all(set(ln['summary']) == set(NAMES) for ln in lines[:-1])
    assert lines[-1]['check'] == 'streaming_fast_posterior_parity'
    assert set(lines[-1]['shifts']) == set(NAMES) | {'logZ'}
    assert lines[-1]['ok'] and rc == 0


@pytest.mark.parametrize('argv, head', [
    (['--mocks', '2'], '2 mocks, likelihood form = gaussian'),
    (['--mocks', '1', '--method', 'smc', '--particles', '32', '--moves',
      '1'], '1 mocks, likelihood form = gaussian, method = smc'),
], ids=['map', 'smc'])
def test_coverage_main(narrow, capsys, argv, head):
    assert _exit_code(tcov.main, argv + ['--device', 'cpu']) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith(head)
    assert [ln.split()[0] for ln in lines[1:5]] == NAMES
    if '--method' not in argv:
        assert lines[5].startswith('overall 68.3%-interval coverage: ')


@pytest.mark.parametrize('method', ['map_profile_debias', 'ns', 'mh',
                                    'ensemble', 'sbc'])
def test_coverage_methods_on_cpu(method):
    """The methods the mains above do not reach, at tiny sizes on the
    narrow tables: finite pulls (ranks in [0, 1]) of the block's shape."""
    _, tb = _pair()
    kw = dict(n_mocks=1, device='cpu')
    if method == 'sbc':
        ranks, names = tcov.run_sbc(tb, n_particles=32, n_moves=1, **kw)
        assert ranks.shape == (1, 4) and ((ranks >= 0) & (ranks <= 1)).all()
        return
    if method == 'map_profile_debias':
        pulls, hit68, names, beta_iv = tcov.run_coverage(
            tb, adam_steps=20, newton_steps=2, n_starts=2, beta_profile=True,
            debias=4, **kw)
        assert beta_iv.shape == (1, 2) and 0.0 <= hit68 <= 1.0
    else:
        fn, sizes = {
            'ns': (tcov.run_coverage_ns, dict(n_live=32, n_steps=2,
                                              dlogz=0.5)),
            'mh': (tcov.run_coverage_mh, dict(n_chains=2, n_warmup=20,
                                              n_samples=20)),
            'ensemble': (tcov.run_coverage_ensemble, dict(n_walkers=8,
                                                          max_steps=20))}[
            method]
        pulls, cover68, names = fn(tb, **sizes, **kw)
        assert cover68.shape == (4,)
    assert pulls.shape == (1, 4) and np.isfinite(pulls).all()
    assert names == NAMES


def test_tension_probe_main(narrow, capsys):
    """Both cases' JSON lines and an exit code that follows them. At 32
    particles x 1 move (the card runs 4096 x 8) the SMC evidences are too
    noisy for ln R to cross zero at 6 sigma: the injection reads
    concordance, and the probe exits 1, as it must."""
    rc = _exit_code(tten.main, ['--particles', '32', '--moves', '1',
                                '--device', 'cpu'])
    lines = [json.loads(ln) for ln in
             capsys.readouterr().out.strip().splitlines()]
    assert [ln['case'] for ln in lines] == ['control', 'injected']
    for ln in lines:
        assert ln['ok'] == tten.verdict(ln['case'], ln['injected_nsigma'],
                                        types.SimpleNamespace(
                                            logr=ln['ln_R'],
                                            shift_nsigma=ln['shift_nsigma'])
                                        )[0]
    assert rc == (0 if all(ln['ok'] for ln in lines) else 1)


@pytest.mark.parametrize('tool', ['validate_posterior', 'dispersion_fast',
                                  'coverage', 'tension'])
def test_tool_exits_2_without_a_card(tool, monkeypatch, capsys):
    """Without a card the default --device cuda exits 2 and names
    --device cpu; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    main = {'validate_posterior': tpost, 'dispersion_fast': tdisp,
            'coverage': tcov, 'tension': tten}[tool].main
    assert _exit_code(main, []) == 2
    captured = capsys.readouterr()
    assert '--device cpu' in captured.err and captured.out == ''
