"""The ESM's table modes of P(k) through the port: the table generator
(tools/make_camb_table_torch.py), the pk_table_file and pk_grid_file modes
with gradients through the cosmology grid, and the grid mode's
posterior-level check (tools/validate_camb_grid_torch.py), against
tools/make_camb_table.py, tools/validate_camb_grid.py and victor_tpu.

Tables come from the tools on the CPU in f64; likelihoods are built at a
narrow width (n_mu 20, n_v 10) where a whole width is not needed. jax and
victor_tpu are imported inside the tests that use them, so that the
`cuda`-marked test runs on a machine without them (`--noconftest`).
"""

import ast
import contextlib
import copy
import dataclasses
import io
import os
import sys
import types

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, 'tools'))

import make_camb_table as jmct  # noqa: E402
import make_camb_table_torch as tmct  # noqa: E402
import validate_camb_grid as jvcg  # noqa: E402
import validate_camb_grid_torch as tvcg  # noqa: E402
from _torch_common import load_config  # noqa: E402
from victor_tpu_torch.io import build_tables as tbuild  # noqa: E402
from victor_tpu_torch.io.tables import tables_to_arrays  # noqa: E402
from victor_tpu_torch.sampling import targets as ttargets  # noqa: E402
from victor_tpu_torch.utils.profiling import total  # noqa: E402

torch.set_num_threads(1)
NARROW = {'n_mu': 20, 'n_v': 10}
Z_EFF = 0.57
# the tools' argv (the output path appended): the ESM defaults' single
# table and the 2 x 2 grid of tests/test_esm_camb_grid.py
TOOL_ARGV = {
    'table': ['--generator', 'eh', '--z', '0.57', '--npts', '400'],
    'grid': ['--generator', 'eh', '--z', '0.57', '--grid', 'H0=65,70',
             '--grid', 'Omega_m=0.29,0.33', '--npts', '400'],
}
# a grid over three axes for the gradients: H0 and ns as
# tools/validate_camb_grid.py spans them, Omega_m beside them
GRAD_GRID_ARGV = ['--generator', 'eh', '--z', '0.57', '--grid',
                  'H0=60,65,70,75', '--grid', 'Omega_m=0.29,0.33', '--grid',
                  'ns=0.90,0.95,1.00', '--npts', '400']
GRAD_AXES = ['H0', 'Omega_m', 'ns']
# (H0, Omega_m, ns): between nodes; on a node of every axis (t = 1 at the
# upper end of an interval: the clip's tie); outside the hull on two axes
GRAD_POINTS = {'off-node': [66.4, 0.302, 0.945],
               'node': [65.0, 0.33, 0.95],
               'outside': [58.0, 0.35, 0.945]}


def _tree(name):
    with open(os.path.join(REPO, 'tools', name)) as f:
        return ast.parse(f.read())


def _arguments(name):
    """{flag: its add_argument keywords} of the tool's main (literals;
    the names of types and of list defaults as source text)."""
    main = next(node for node in _tree(name).body
                if isinstance(node, ast.FunctionDef) and node.name == 'main')
    out = {}
    for node in ast.walk(main):
        if isinstance(node, ast.Call) and getattr(
                node.func, 'attr', None) == 'add_argument':
            flag = ast.literal_eval(node.args[0])
            out[flag] = {kw.arg: ast.unparse(kw.value)
                         for kw in node.keywords}
    return out


def _run_main(main, argv):
    """`main()` with sys.argv = argv: (exit code, stdout)."""
    saved, sys.argv = sys.argv, argv
    buf = io.StringIO()
    code = 0
    try:
        with contextlib.redirect_stdout(buf):
            main()
    except SystemExit as exc:
        code = exc.code
    finally:
        sys.argv = saved
    return code, buf.getvalue()


def _write(tool_main, argv, path):
    """One tool's main in this process, writing `path`: its stdout."""
    code, out = _run_main(tool_main, ['tool'] + argv + ['--out', str(path)])
    assert code == 0, out
    return out


@pytest.fixture(scope='module')
def written(tmp_path_factory):
    """Each of TOOL_ARGV written by both tools' mains in this process:
    {case: {'jax' | 'torch': (path, stdout)}}."""
    out = {}
    for case, argv in TOOL_ARGV.items():
        out[case] = {}
        for tag, main, extra in (('jax', jmct.main, []),
                                 ('torch', tmct.main, ['--device', 'cpu'])):
            path = tmp_path_factory.mktemp(tag) / f'{case}.npz'
            out[case][tag] = (str(path), _write(main, argv + extra, path))
    return out


def _esm_model(**esm_opts):
    """configs/esm_sampling_config.yaml's config, P(k) set by `esm_opts`
    (the .npz copies of the data where h5py is absent)."""
    cfg = load_config('esm_sampling_config.yaml')
    cfg['model']['matter_ccf']['excursion_set_options'] = {
        'use_eisenstein_hu': False, **esm_opts}
    return cfg


# ---------------------------------------------------------------------------
# the copied constants and flags
# ---------------------------------------------------------------------------

def test_constants_and_flags_equal_original():
    """Both tools keep their original's constants and every flag with its
    keywords (the port's --device aside)."""
    assert tmct.AXIS_NAMES == jmct.AXIS_NAMES
    for name in ('H0_GRID', 'NS_GRID', 'COSMO_PARAMS'):
        assert getattr(tvcg, name) == getattr(jvcg, name), name
    for original, port in (('make_camb_table.py', 'make_camb_table_torch.py'),
                           ('validate_camb_grid.py',
                            'validate_camb_grid_torch.py')):
        got = _arguments(port)
        assert got.pop('--device')['default'] == "'cuda'"
        assert got == _arguments(original), port


# ---------------------------------------------------------------------------
# the generator against the JAX tool's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('z', [0.0, 0.57])
@pytest.mark.parametrize('cosmo', [(0.675, 0.31, 0.048, 0.96),
                                   (0.60, 0.27, 0.044, 0.90),
                                   (0.75, 0.35, 0.052, 1.00)],
                         ids=['fiducial', 'low', 'high'])
def test_pk_eh_matches_jax_tool(cosmo, z):
    common = dict(mnu=0.06, z=z, kmax=2.0, npts=400, accuracy=1.0)
    k, pk0, s80, s8z = tmct._pk_eh(*cosmo, **common, device='cpu')
    jk, jpk0, js80, js8z = jmct._pk_eh(*cosmo, **common)
    np.testing.assert_array_equal(k, jk)
    np.testing.assert_allclose(pk0, jpk0, rtol=1e-12, atol=0)
    assert abs(s80 - js80) <= 1e-12 * js80
    assert abs(s8z - js8z) <= 1e-12 * js8z


@pytest.mark.parametrize('case', sorted(TOOL_ARGV))
def test_main_writes_what_original_writes(written, case):
    """The same keys, dtypes and values within 1e-12, and the same line."""
    (jpath, jout), (tpath, tout) = written[case]['jax'], written[case]['torch']
    assert tout.replace(tpath, 'OUT') == jout.replace(jpath, 'OUT')
    assert tout.startswith(f'wrote {tpath}: ')
    j, t = np.load(jpath), np.load(tpath)
    assert sorted(t.files) == sorted(j.files)
    for key in j.files:
        assert t[key].dtype == j[key].dtype, key
        if j[key].dtype.kind == 'f':
            np.testing.assert_allclose(t[key], j[key], rtol=1e-12, atol=0,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(t[key], j[key], err_msg=key)


def test_camb_generator_without_camb_exits_as_original(monkeypatch,
                                                        tmp_path):
    monkeypatch.setitem(sys.modules, 'camb', None)    # import camb raises
    argv = ['--generator', 'camb', '--out', str(tmp_path / 'x.npz')]
    want = _run_main(jmct.main, ['make_camb_table.py'] + argv)
    got = _run_main(tmct.main, ['make_camb_table_torch.py'] + argv)
    assert got == want
    assert 'camb is not installed' in want[0]
    assert not (tmp_path / 'x.npz').exists()


@pytest.mark.parametrize('argv, message', [
    (['--grid', 'w0=1,2'], "--grid axis 'w0' must be one of"),
    (['--grid', 'H0=70,65'], '--grid H0: values must be strictly increasing'),
], ids=['axis', 'order'])
def test_grid_validation_exits_as_original(tmp_path, argv, message):
    argv = ['--generator', 'eh'] + argv + ['--out', str(tmp_path / 'x.npz')]
    want = _run_main(jmct.main, ['make_camb_table.py'] + argv)
    got = _run_main(tmct.main, ['make_camb_table_torch.py'] + argv +
                    ['--device', 'cpu'])
    assert got == want
    assert want[0].startswith(message)


@pytest.mark.parametrize('case', sorted(TOOL_ARGV))
def test_port_tables_equal_victor_tpu(written, case):
    """The port tool's file through the port's build_tables against the
    JAX tool's file through victor_tpu's: every leaf within 1e-12."""
    from victor_tpu.io import build_tables as jbuild
    key = 'pk_table_file' if case == 'table' else 'pk_grid_file'
    jcfg = _esm_model(**{key: written[case]['jax'][0]})
    tcfg = _esm_model(**{key: written[case]['torch'][0]})
    jb = jbuild(jcfg['model'], jcfg['data'], **NARROW)
    tb = tbuild(tcfg['model'], tcfg['data'], **NARROW, device='cpu')
    assert dataclasses.asdict(tb.spec) == dataclasses.asdict(jb.spec)
    if case == 'grid':
        assert tb.spec.esm_grid_names == ('H0', 'Omega_m')
    want = tables_to_arrays(jb.tables)
    got = tables_to_arrays(tb.tables)
    for name, w in want.items():
        g = got[name]
        assert (g is None) == (w is None), name
        for a, b in zip(g if isinstance(w, tuple) else [g],
                        w if isinstance(w, tuple) else [w]):
            if b is not None:
                np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                           rtol=1e-12, atol=0, err_msg=name)


# ---------------------------------------------------------------------------
# gradients through the cosmology grid
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def grad_grid(tmp_path_factory):
    path = tmp_path_factory.mktemp('gradgrid') / 'grid.npz'
    _write(tmct.main, GRAD_GRID_ARGV + ['--device', 'cpu'], path)
    return str(path)


def _grad_names():
    return list(load_config('esm_sampling_config.yaml')['params']) + \
        GRAD_AXES


def _grad_points():
    cfg = load_config('esm_sampling_config.yaml')
    ref = [cfg['params'][k]['ref']['loc'] for k in cfg['params']]
    return np.array([ref + GRAD_POINTS[p] for p in GRAD_POINTS])


def _port_grad(bundle, names, points, device):
    """d lnL / d theta of the port (AD-resolved modes) at `points`."""
    tables, loglike = ttargets.resolve_target(bundle, None, None,
                                              gradient_free=False)
    th = torch.tensor(points, dtype=torch.float64, device=device,
                      requires_grad=True)
    lnl = loglike(tables, {k: th[:, i] for i, k in enumerate(names)})[0]
    (grad,) = torch.autograd.grad(lnl.sum(), th)
    return lnl.detach().cpu().numpy(), grad.cpu().numpy()


@pytest.fixture(scope='module')
def grid_grads(grad_grid):
    """victor_tpu's jax.grad and the port's autograd of lnL through grid
    mode at GRAD_POINTS, on one set of tables (the narrow width)."""
    import jax
    import jax.numpy as jnp
    from victor_tpu.io import build_tables as jbuild
    from victor_tpu.sampling import targets as jtargets
    from victor_tpu_torch.io.tables import bundle_from_arrays
    cfg = _esm_model(pk_grid_file=grad_grid)
    jb = jbuild(copy.deepcopy(cfg['model']), copy.deepcopy(cfg['data']),
                **NARROW)
    tb = bundle_from_arrays(tables_to_arrays(jb.tables),
                            dataclasses.asdict(jb.spec),
                            dataclasses.asdict(jb.theory_opts),
                            dataclasses.asdict(jb.fit_opts), device='cpu')
    names, points = _grad_names(), _grad_points()
    tbl, loglike, _ = jtargets.resolve_target(jb, None, None,
                                              gradient_free=False)
    want = np.asarray(jax.jit(jax.vmap(jax.grad(
        lambda th: loglike(tbl, dict(zip(names, th)))[0])))(
            jnp.asarray(points)))
    return _port_grad(tb, names, points, 'cpu')[1], want


@pytest.mark.parametrize('i, point', list(enumerate(GRAD_POINTS)))
def test_grid_gradient_matches_jax_grad(grid_grads, i, point):
    """d lnL / d theta over the ESM parameters, H0, Omega_m and ns within
    1e-9 relative of jax.grad (relative to each entry, or to 1e-6 of the
    largest where an entry is zero: H0 outside the hull). At the node the
    clip's tie gives half the one-sided derivative, as jnp.clip does;
    outside the hull the clamped axis has none."""
    got, want = grid_grads[0][i], grid_grads[1][i]
    rel = np.abs(got - want) / np.maximum(np.abs(want),
                                          1e-6 * np.abs(want).max())
    assert rel.max() <= 1e-9, (point, rel)
    h0 = _grad_names().index('H0')
    assert (got[h0] == 0.0) == (point == 'outside')


def test_grid_clamp_has_no_derivative_outside_and_half_at_a_node(grad_grid):
    """The interpolation's own derivative in H0 (d s80_fid / d H0): zero
    below the hull, half the one-sided slope at an interior node, whose
    slopes the two intervals give."""
    from victor_tpu_torch.models import esm as tesm
    cfg = _esm_model(pk_grid_file=grad_grid)
    tb = tbuild(cfg['model'], cfg['data'], **NARROW, device='cpu')

    def slope(h0):
        x = torch.tensor([h0], dtype=torch.float64, requires_grad=True)
        s80 = tesm._esm_grid_interp(tb.tables, tb.spec, {
            'H0': x, 'Omega_m': torch.tensor([0.302], dtype=torch.float64),
            'ns': torch.tensor([0.945], dtype=torch.float64)})[1]
        return float(torch.autograd.grad(s80.sum(), x)[0])
    assert slope(58.0) == 0.0
    below, above = slope(64.9), slope(65.1)
    assert below != above
    np.testing.assert_allclose(slope(65.0), 0.5 * below, rtol=1e-12)


def test_table_mode_shares_one_table_across_rows(written):
    """Table mode keeps one (nk,) table: each row's P(k) is that table
    times the row's normalisation, with no per-row table in the bundle."""
    from victor_tpu_torch.models import esm as tesm
    cfg = _esm_model(pk_table_file=written['table']['torch'][0])
    tb = tbuild(cfg['model'], cfg['data'], **NARROW, device='cpu')
    s80 = torch.tensor([0.8, 0.81, 0.82], dtype=torch.float64)
    st = tesm.esm_state(tb.tables, tb.spec, {'sigma_8_0': s80})
    assert tb.tables.esm_pk0.shape == st['k'].shape
    assert st['pk'].shape == s80.shape + st['k'].shape
    np.testing.assert_allclose(
        st['pk'].numpy(), (tb.tables.esm_pk0[None] * (
            s80 / tb.tables.esm_s80)[:, None] ** 2).numpy(), rtol=1e-15)


# ---------------------------------------------------------------------------
# validate_camb_grid: the verdict and the main
# ---------------------------------------------------------------------------

# (mean shift of each marginal in sigma, sd ratio, logZ delta, the one
# marginal that differs or None)
VERDICT_CASES = {
    'pass': (0.05, 1.02, 0.1, None),
    'fails_shift': (0.05, 1.02, 0.1, (0.4, 1.0)),
    'fails_ratio': (0.05, 1.02, 0.1, (0.05, 1.4)),
    'fails_median': (0.2, 1.0, 0.1, None),
    'fails_logz': (0.05, 1.0, 0.5, None),
}


def _fake_runs(case, n=11):
    """Particles and logZ of the EH and the grid run of `case`."""
    shift, ratio, dlogz, odd = VERDICT_CASES[case]
    rng = np.random.default_rng(3)
    mean = rng.uniform(-2.0, 2.0, n)
    sd = rng.uniform(0.1, 1.0, n)
    eh = mean + sd * rng.standard_normal((2048, n))
    shifts, ratios = np.full(n, shift), np.full(n, ratio)
    if odd is not None:
        shifts[3], ratios[3] = odd
    grid = eh.mean(0) + shifts * eh.std(0) + ratios * (eh - eh.mean(0))
    return {'eh': (eh, 277.4), 'grid': (grid, 277.4 + dlogz)}


@pytest.mark.parametrize('case', sorted(VERDICT_CASES))
def test_verdict_matches_original_rule(case, monkeypatch):
    """validate_camb_grid_torch.compare on fake SMC results against the JAX
    tool's main, whose run_smc returns the same results: the same table and
    verdict lines and the same exit code."""
    import victor_tpu.io
    import victor_tpu.sampling
    import victor_tpu.utils.profiling
    runs = _fake_runs(case)

    def fake_smc(bundle, block, n_particles, n_moves, seed):
        mode = 'eh' if bundle['matter_ccf']['excursion_set_options'][
            'use_eisenstein_hu'] else 'grid'
        particles, logz = runs[mode]
        return types.SimpleNamespace(particles=particles, logz=logz,
                                     elapsed_s=1.0)
    monkeypatch.setattr(victor_tpu.sampling, 'run_smc', fake_smc)
    monkeypatch.setattr(victor_tpu.io, 'build_tables', lambda m, d: m)
    monkeypatch.setattr(victor_tpu.utils.profiling,
                        'enable_persistent_cache', lambda *a, **k: None)
    monkeypatch.setattr(jvcg.subprocess, 'run', lambda *a, **k:
                        types.SimpleNamespace(returncode=0,
                                              stdout='wrote grid\n',
                                              stderr=''))
    code, out = _run_main(jvcg.main, ['validate_camb_grid.py'])
    results = {mode: (p.mean(axis=0), p.std(axis=0), logz)
               for mode, (p, logz) in runs.items()}
    names = list(load_config('esm_sampling_config.yaml')['params']) + \
        list(tvcg.COSMO_PARAMS)
    ok, lines = tvcg.compare(results, names)
    table = out[out.index('\n\n') + 1:]
    assert '\n'.join(lines) + '\n' == table
    assert code == (0 if ok else 1)
    assert ok == (case == 'pass')


def test_validate_camb_grid_main_on_cpu(monkeypatch, capsys):
    """The port tool's main on the CPU with run_smc replaced by a stand-in
    that returns _fake_runs('pass'): the grid is written by
    make_camb_table_torch.py in a subprocess and read into grid mode over
    (H0, ns); the EH run uses EH mode; the block has 11 parameters."""
    runs = _fake_runs('pass')
    seen = []

    def fake_smc(bundle, block, n_particles, n_moves, seed, device):
        seen.append((bundle.spec.esm_use_eh, bundle.spec.esm_grid_names,
                     list(block), n_particles, n_moves, seed, device))
        particles, logz = runs['eh' if bundle.spec.esm_use_eh else 'grid']
        return types.SimpleNamespace(particles=particles, logz=logz,
                                     elapsed_s=2.0, betas=np.zeros(6))
    monkeypatch.setattr(tvcg, 'run_smc', fake_smc)
    monkeypatch.setattr(tvcg, 'build_tables', lambda m, d, device: tbuild(
        m, d, device=device, **NARROW))
    code = 0
    try:
        tvcg.main(['--device', 'cpu'])
    except SystemExit as exc:
        code = exc.code
    lines = capsys.readouterr().out.splitlines()
    assert code == 0
    assert lines[0] == 'card: cpu'
    assert lines[1].endswith(': 2-axis grid (4, 3) (12 eh tables), '
                             'sigma8(0) range [0.69315, 0.93044]')
    assert lines[2:6] == ['eh: logZ = 277.400 (2.0 s)',
                          '  5 stages, 63488 likelihood evaluations, '
                          '31744.0 evals/s',
                          'grid: logZ = 277.500 (2.0 s)',
                          '  5 stages, 63488 likelihood evaluations, '
                          '31744.0 evals/s']
    assert lines[-1].startswith('PASS: ')
    assert [s[:2] for s in seen] == [(True, ()), (False, ('H0', 'ns'))]
    assert all(s[2][-2:] == ['H0', 'ns'] and len(s[2]) == 11 and
               s[3:] == (4096, 6, 0, 'cpu') for s in seen)


@pytest.mark.parametrize('tool', ['make_camb_table', 'validate_camb_grid'])
def test_tool_exits_2_without_a_card(tool, monkeypatch, capsys, tmp_path):
    """Without a card the default --device cuda exits 2 and names
    --device cpu; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    if tool == 'make_camb_table':
        argv = ['--generator', 'eh', '--out', str(tmp_path / 'x.npz')]
        main = tmct.main
    else:
        argv, main = [], tvcg.main
    with pytest.raises(SystemExit) as exc:
        main(argv)
    assert exc.value.code == 2
    captured = capsys.readouterr()
    assert '--device cpu' in captured.err and captured.out == ''
    assert not (tmp_path / 'x.npz').exists()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: run on the GPU machine with '
                    '`python -m pytest --noconftest '
                    'tests/test_torch_camb_grid.py -m cuda`')
    return torch.device('cuda')


@pytest.mark.cuda
def test_grid_gradient_on_card(cuda_device, tmp_path):
    """The generator on the card equals it on the CPU within 1e-12, and
    grid mode's lnL and gradient on the card, through the forward and
    backward kernels, equal the CPU's within 1e-9."""
    paths = {}
    for dev in ('cpu', 'cuda'):
        paths[dev] = tmp_path / f'{dev}.npz'
        _write(tmct.main, GRAD_GRID_ARGV + ['--device', dev], paths[dev])
    a, b = np.load(paths['cpu']), np.load(paths['cuda'])
    for key in ('logpk0', 'sigma8_0', 'sigma8_z'):
        np.testing.assert_allclose(b[key], a[key], rtol=1e-12, atol=0)
    cfg = _esm_model(pk_grid_file=str(paths['cpu']))
    tb = tbuild(cfg['model'], cfg['data'], **NARROW, device='cpu')
    names, points = _grad_names(), _grad_points()
    lnl, grad = _port_grad(tb, names, points, 'cpu')
    before = (total('ppoly.launches'), total('ppoly.bwd_launches'))
    lnl_c, grad_c = _port_grad(tb.to(cuda_device, torch.float64), names,
                               points, cuda_device)
    assert total('ppoly.launches') > before[0] and \
        total('ppoly.bwd_launches') > before[1]
    np.testing.assert_allclose(lnl_c, lnl, rtol=1e-9)
    np.testing.assert_allclose(grad_c, grad, rtol=1e-9,
                               atol=1e-9 * np.abs(grad).max())


# ---------------------------------------------------------------------------
# chip_smoke.py phase 19a's goldens
# ---------------------------------------------------------------------------

def _chip_smoke_literals(*names):
    tree = ast.parse(open(os.path.join(REPO, 'chip_smoke.py')).read())
    found = {t.id: ast.literal_eval(node.value) for node in tree.body
             if isinstance(node, ast.Assign) for t in node.targets
             if isinstance(t, ast.Name) and t.id in names}
    return tuple(found[n] for n in names)


def camb_grid_goldens(table_path, grid_path):
    """Phase 19a's values from victor_tpu on the CPU in f64 at full width,
    on configs/esm_sampling_config.yaml with P(k) from the table at
    `table_path` and from the (H0, ns) grid at `grid_path`: chi2 and lnL
    (exact modes) at ESM_REF in table mode and at each of ESM_GRID_POINTS
    in grid mode, d lnL / d theta there and the 11 x 11 -Hessian at the
    off-node point (AD-resolved modes), and ExcursionSetProfile(pk_table=)'s
    fiducial sigma8 values, P(k, z) at API_K, enclosed profile and
    density_evolution at API_R after set_normalisation(0.81)."""
    import jax
    import jax.numpy as jnp
    from victor_tpu.io import build_tables as jbuild
    from victor_tpu.likelihood import core as jlk
    from victor_tpu.models.esm import ExcursionSetProfile
    from victor_tpu.sampling import targets as jtargets
    esm_ref, points, esp_args, profile, r, k = _chip_smoke_literals(
        'ESM_REF', 'ESM_GRID_POINTS', 'ESP_ARGS', 'ESP_PROFILE', 'API_R',
        'API_K')
    exact = {'streaming_eval': 'exact', 'beta_covariance': 'exact'}
    names = list(esm_ref) + ['H0', 'ns']
    out = {}
    for mode, key, path in (('table', 'pk_table_file', table_path),
                            ('grid', 'pk_grid_file', grid_path)):
        cfg = _esm_model(**{key: path})
        jb = jbuild(cfg['model'], cfg['data'])
        opts = jb.theory_opts.replace(**exact)
        pts = {'ref': [esm_ref[n] for n in names[:9]]} if mode == 'table' \
            else {p: [esm_ref[n] for n in names[:9]] + v
                  for p, v in points.items()}
        for p, th in pts.items():
            lnl, chi2 = jlk.log_likelihood(
                jb.tables, jb.spec, opts, jb.fit_opts,
                {n: jnp.asarray(v) for n, v in zip(names, th)})
            out[f'{mode} {p}'] = [float(chi2), float(lnl)]
        if mode == 'grid':
            tbl, loglike, _ = jtargets.resolve_target(jb, None, None,
                                                      gradient_free=False)

            def lnl_of(th):
                return loglike(tbl, dict(zip(names, th)))[0]
            th = jnp.asarray(list(pts.values()))
            grads = np.asarray(jax.jit(jax.vmap(jax.grad(lnl_of)))(th))
            for p, g in zip(pts, grads):
                out[f'grad {p}'] = g.tolist()
            out['hessian off-node'] = np.asarray(jax.jit(jax.hessian(
                lambda t: -lnl_of(t)))(th[0])).tolist()
    tbl = dict(np.load(table_path))
    esp = ExcursionSetProfile(**esp_args, use_eisenstein_hu=False,
                              pk_table=tbl)
    esp.set_normalisation(0.81)
    lagrange = np.linspace(1.0, 120.0, 60)
    out['esp fiducial'] = [esp.s80_fiducial, esp.s8z_fiducial]
    out['esp power'] = np.asarray(esp.power(np.array(k), profile[0])).tolist()
    out['esp enclosed'] = np.asarray(esp.model_enclosed_density_profile(
        lagrange, *profile)(np.array(r))).tolist()
    out['esp evolution'] = np.asarray(esp.density_evolution(*profile)(
        np.array(r))).tolist()
    return out


@pytest.mark.slow
def test_chip_smoke_camb_grid_goldens(tmp_path):
    """chip_smoke.py holds phase 19a on the card to victor_tpu's values:
    this recomputes ESM_CAMB_GOLDENS from the JAX tool's table and grid,
    written with the script's own arguments (about 2 minutes here, the
    full-width 11 x 11 jax.hessian most of it)."""
    table_argv, grid_argv, want = _chip_smoke_literals(
        'CAMB_TABLE_ARGV', 'CAMB_GRID_ARGV', 'ESM_CAMB_GOLDENS')
    assert grid_argv[grid_argv.index('--grid') + 1] == f'H0={jvcg.H0_GRID}'
    assert grid_argv[-1] == f'ns={jvcg.NS_GRID}'
    paths = [tmp_path / 'table.npz', tmp_path / 'grid.npz']
    for argv, path in zip((table_argv, grid_argv), paths):
        _write(jmct.main, argv, path)
    got = camb_grid_goldens(*map(str, paths))
    assert list(got) == list(want)
    for key, g in got.items():
        g, w = np.asarray(g), np.asarray(want[key])
        np.testing.assert_allclose(w, g, rtol=0,
                                   atol=1e-11 * np.abs(g).max(), err_msg=key)
