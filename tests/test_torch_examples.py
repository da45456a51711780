"""The port's walkthroughs and tools (`examples/*_torch.py`,
`tools/plot_chains_torch.py`, `tools/make_notebooks_torch.py`) against the
victor_tpu originals they port.

In one process on the CPU in f64: the model-options tour and the usage
walkthrough at full width (every lnL and chi2 to 1e-9, the printed lines
equal), the multi-quantile walkthrough at a narrow width (n_mu 20, n_v 10,
`build_tables` patched in both example modules and in both packages' joint
builders) with chip_smoke.py phase 18a's tolerances, the chain statistics
of plot_chains_torch.py against tools/plot_chains.py on one chain root the
port wrote, and the notebooks that make_notebooks_torch.py authors. Every
new file that computes on the card exits 2 when asked for a card that is
not there, the host-only tools run without one, and none imports jax or
victor_tpu. chip_smoke.py's EXAMPLE_GOLDENS are recomputed here
with victor_tpu, but the MAP's Laplace numbers and the profile interval:
tests/test_torch_examples_inference.py holds the inference walkthrough.
"""

import ast
import contextlib
import copy
import functools
import io
import os
import re
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, 'examples'))
sys.path.insert(0, os.path.join(REPO, 'tools'))

import inference_demo as jinf  # noqa: E402
import inference_demo_torch as tinf  # noqa: E402
import make_notebooks_torch as tnb  # noqa: E402
import model_options_demo as jopt  # noqa: E402
import model_options_demo_torch as topt  # noqa: E402
import multiquantile_demo as jmq  # noqa: E402
import multiquantile_demo_torch as tmq  # noqa: E402
import plot_chains as jchains  # noqa: E402
import plot_chains_torch as tchains  # noqa: E402
import usage_demo as jusage  # noqa: E402
import usage_demo_torch as tusage  # noqa: E402

torch.set_num_threads(1)
NARROW = {'n_mu': 20, 'n_v': 10}
NEW_FILES = ['examples/model_options_demo_torch.py',
             'examples/usage_demo_torch.py',
             'examples/inference_demo_torch.py',
             'examples/multiquantile_demo_torch.py',
             'tools/plot_chains_torch.py', 'tools/make_notebooks_torch.py']
DEVICE_FILES = [f for f in NEW_FILES if f != 'tools/plot_chains_torch.py']
NAMES = ['fsigma8', 'beta', 'sigma_v', 'epsilon']


def _literals(*names):
    """Top-level literals of chip_smoke.py (read with ast: importing it
    would install its hook that refuses jax)."""
    with open(os.path.join(REPO, 'chip_smoke.py')) as f:
        tree = ast.parse(f.read())
    found = {t.id: ast.literal_eval(node.value) for node in tree.body
             if isinstance(node, ast.Assign) for t in node.targets
             if isinstance(t, ast.Name) and t.id in names}
    return tuple(found[n] for n in names)


def _run(main, argv=None, jax_argv=None):
    """(return value, stdout lines) of an example's main; a JAX original's
    main reads sys.argv (`jax_argv`)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.MonkeyPatch.context() as mp:
        if jax_argv is not None:
            mp.setattr(sys, 'argv', jax_argv)
            out = main()
        else:
            out = main(argv)
    return out, buf.getvalue().splitlines()


def _recorder(mp, owner, name):
    """Record the results of owner.name while the patch `mp` is active."""
    real, seen = getattr(owner, name), []

    def wrapped(*args, **kw):
        out = real(*args, **kw)
        seen.append(out)
        return out
    mp.setattr(owner, name, wrapped)
    return seen


def _rel(got, want):
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    return float(np.max(np.abs(got - want) / np.abs(want)))


# ---------------------------------------------------------------------------
# the model-options tour and the usage walkthrough, full width
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def jax_options():
    """victor_tpu's tour: its printed lines and every (lnL, chi2)."""
    import victor_tpu
    with pytest.MonkeyPatch.context() as mp:
        seen = _recorder(mp, victor_tpu.CCFFit, 'log_likelihood')
        _, lines = _run(jopt.main, jax_argv=['model_options_demo.py'])
    return lines, [list(map(float, v)) for v in seen]


@pytest.fixture(scope='module')
def port_options():
    rows, lines = _run(topt.main, ['--device', 'cpu'])
    return lines, rows


def test_model_options_demo_matches_victor_tpu(jax_options, port_options):
    """All 20 options: the printed lines equal victor_tpu's character for
    character, none bracketed (an error), every (lnL, chi2) within 1e-9."""
    jlines, jvalues = jax_options
    tlines, rows = port_options
    assert tlines == jlines
    assert not [ln for ln in tlines if re.search(r'\s\[\w+: ', ln)]
    assert len(rows) == len(jvalues) == 20
    assert all(lnl is not None for _, lnl, _ in rows)
    got = [[lnl, chi2] for _, lnl, chi2 in rows]
    np.testing.assert_allclose(got, jvalues, rtol=1e-9)


@pytest.fixture(scope='module')
def jax_usage():
    """victor_tpu's walkthrough (no --sample): its lines, checkpoints,
    multipoles and xi(5, 5)."""
    import victor_tpu
    with pytest.MonkeyPatch.context() as mp:
        lnl = _recorder(mp, victor_tpu.CCFFit, 'log_likelihood')
        mult = _recorder(mp, victor_tpu.CCFFit, 'theory_multipoles')
        xi2d = _recorder(mp, victor_tpu.CCFFit, 'theory_xi_2D')
        _, lines = _run(jusage.main, jax_argv=['usage_demo.py'])
    return {'lines': lines,
            'checkpoints': [list(map(float, v)) for v in lnl],
            'multipoles': {k: np.asarray(v) for k, v in mult[0].items()},
            'xi_5_5': float(xi2d[0](5.0, 5.0)[0, 0])}


@pytest.fixture(scope='module')
def port_usage():
    """The port's walkthrough on the CPU; its timed batch cut from 128 to
    16 points (the default modes run ~14 evals/s on one CPU thread)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tusage, 'N_POINTS', {**tusage.N_POINTS, 'cpu': 16})
        out, lines = _run(tusage.main, ['--device', 'cpu'])
    return out, lines


def test_usage_demo_matches_victor_tpu(jax_usage, port_usage):
    """The five checkpoints, the multipoles and xi(5, 5) within 1e-9; the
    printed lines equal up to the rate line and the phase times."""
    out, lines = port_usage
    got = [list(v) for v in out['checkpoints'].values()]
    assert list(out['checkpoints']) == [k for k, _ in tusage.CHECKPOINTS]
    np.testing.assert_allclose(got, jax_usage['checkpoints'], rtol=1e-9)
    for ell in ('0', '2'):
        want = jax_usage['multipoles'][ell]
        np.testing.assert_allclose(out['multipoles'][ell], want, rtol=0,
                                   atol=1e-9 * np.abs(want).max())
    assert out['xi_5_5'] == pytest.approx(jax_usage['xi_5_5'], rel=1e-9)

    def head(ls):
        return ls[:ls.index('--- batched throughput ---')]
    assert head(lines) == head(jax_usage['lines'])
    rate = next(ln for ln in lines if 'likelihood evals/sec on cpu' in ln)
    assert '16 points in chunks of 128' in rate and \
        '11.8/sec on one CPU core' in rate
    assert out['n_points'] == 16 and np.isfinite(out['evals_per_s'])
    assert lines[-1].startswith('phase times: ')


def test_usage_constants_equal_original():
    """The checkpoint list, the timed points and the --sample call keep the
    original's values."""
    tree = ast.parse(open(os.path.join(REPO, 'examples', 'usage_demo.py'))
                     .read())
    loop = next(node for node in ast.walk(tree) if isinstance(node, ast.For)
                and isinstance(node.iter, ast.List))
    assert ast.literal_eval(loop.iter) == tusage.CHECKPOINTS
    call = next(node for node in ast.walk(tree) if isinstance(node, ast.Call)
                and getattr(node.func, 'id', None) == 'run_mcmc')
    kw = {k.arg: ast.literal_eval(k.value) for k in call.keywords
          if k.arg != 'mesh'}
    tree = ast.parse(open(os.path.join(REPO, 'examples',
                                       'usage_demo_torch.py')).read())
    call = next(node for node in ast.walk(tree) if isinstance(node, ast.Call)
                and getattr(node.func, 'id', None) == 'run_mcmc')
    assert kw == {k.arg: ast.literal_eval(k.value) for k in call.keywords
                  if k.arg not in ('mesh', 'device')}
    rng = np.random.default_rng(0)
    want = np.column_stack([
        rng.uniform(0.3, 0.6, 5), rng.uniform(0.25, 0.55, 5),
        rng.uniform(250, 450, 5), rng.uniform(0.9, 1.1, 5)])
    np.testing.assert_array_equal(tusage.throughput_points(5), want)
    assert tusage.N_POINTS == {'cuda': 1024, 'cpu': 128}


# ---------------------------------------------------------------------------
# the inference and multi-quantile walkthroughs, narrow width
# ---------------------------------------------------------------------------

def _narrow_joint(mp, module, attr):
    """The joint tables of `module` (the port's likelihood.multiquantile or
    victor_tpu's) built at the narrow width."""
    real = getattr(module, attr)
    if attr == 'build_tables':
        mp.setattr(module, attr, functools.partial(real, **NARROW))
    else:                                 # _build_arrays(model, data, 100, 50)
        mp.setattr(module, attr, lambda model, data, n_mu, n_v:
                   real(model, data, NARROW['n_mu'], NARROW['n_v']))


def jax_multiquantile(narrow=True):
    """victor_tpu's multi-quantile walkthrough: its lines and numbers in
    the keys of the port's main's return value."""
    import victor_tpu.io
    import victor_tpu.likelihood.multiquantile as jm
    import victor_tpu.sampling.optimize as jo
    with pytest.MonkeyPatch.context() as mp:
        if narrow:
            _narrow_joint(mp, victor_tpu.io, 'build_tables')
            _narrow_joint(mp, jm, 'build_tables')
        lnl = _recorder(mp, jm, 'joint_log_likelihood')
        fisher = _recorder(mp, jo, 'fisher_forecast')
        batch = []
        real_make = jm.make_batched_joint_loglike

        def make(*args, **kw):
            fn = real_make(*args, **kw)

            def call(theta):
                out = fn(theta)
                batch.append(np.asarray(out[0]).tolist())
                return out
            return call
        mp.setattr(jm, 'make_batched_joint_loglike', make)
        _, lines = _run(jmq.main, jax_argv=['multiquantile_demo.py'])
    names = ('fsigma8', 'epsilon')
    return lines, {'lnl': float(lnl[0][0]), 'chi2': float(lnl[0][1]),
                   'chi2_q1': float(lnl[1][1]), 'lnl_batch': batch[0],
                   'sigma_joint': [fisher[0].std[n] for n in names],
                   'sigma_single': [fisher[1].std[n] for n in names]}


def port_multiquantile(narrow=True):
    import victor_tpu_torch.likelihood.multiquantile as tm
    with pytest.MonkeyPatch.context() as mp:
        if narrow:
            _narrow_joint(mp, tmq, 'build_tables')
            _narrow_joint(mp, tm, '_build_arrays')
        out, lines = _run(tmq.main, ['--device', 'cpu'])
    return lines, out


def test_multiquantile_demo_matches_victor_tpu():
    """The joint lnL and chi2, the sigma_v__q1 override and the batched
    lnL of 3 points within 1e-9, the single and joint Fisher sigmas 1e-6;
    the printed lines equal."""
    jlines, want = jax_multiquantile()
    lines, got = port_multiquantile()
    for key in ('lnl', 'chi2', 'chi2_q1', 'lnl_batch'):
        assert _rel(got[key], want[key]) <= 1e-9, key
    for key in ('sigma_joint', 'sigma_single'):
        assert _rel(got[key], want[key]) <= 1e-6, key
    assert lines == jlines
    assert tmq.BATCH == [[0.45, 0.36], [0.47, 0.37], [0.50, 0.39]]


# ---------------------------------------------------------------------------
# the device check and the imports of the new files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('path', DEVICE_FILES)
def test_new_file_exits_2_without_a_card(path, monkeypatch, capsys):
    """Without a card the default --device cuda exits 2 and names
    --device cpu; nothing falls back to the CPU. make_notebooks_torch.py
    checks the card only when it executes the notebooks."""
    module = {'examples/model_options_demo_torch.py': topt,
              'examples/usage_demo_torch.py': tusage,
              'examples/inference_demo_torch.py': tinf,
              'examples/multiquantile_demo_torch.py': tmq,
              'tools/make_notebooks_torch.py': tnb}[path]
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(SystemExit) as exc:
        module.main([])
    assert exc.value.code == 2
    captured = capsys.readouterr()
    assert '--device cpu' in captured.err and captured.out == ''


@pytest.mark.parametrize('tool', ['plot_chains', 'make_notebooks'])
def test_host_tool_runs_without_a_card(tool, chain_root, tmp_path,
                                       monkeypatch):
    """The host-only tools need no card: plot_chains_torch.py takes no
    --device at all, and make_notebooks_torch.py --no-execute writes the
    notebooks with the default DEVICE = 'cuda' into their cells."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    if tool == 'plot_chains':
        _, got = _run(tchains.main, [chain_root])
        assert got[0].startswith('4 chain file(s), ')
        with pytest.raises(SystemExit):
            tchains.main([chain_root, '--device', 'cpu'])
    else:
        import nbformat
        written, _ = _run(tnb.main, ['--no-execute', '--out', str(tmp_path)])
        code = [c.source for c in nbformat.read(written[0], 4).cells
                if c.cell_type == 'code']
        assert "DEVICE = 'cuda'" in code[0]


@pytest.mark.parametrize('path', NEW_FILES)
def test_new_file_imports_neither_jax_nor_victor_tpu(path):
    """No import of jax, victor_tpu, or a module of examples/ or tools/
    that is not the port's."""
    jax_side = {os.path.splitext(f)[0] for d in ('examples', 'tools')
                for f in os.listdir(os.path.join(REPO, d))
                if f.endswith('.py') and not f.endswith('_torch.py')
                and f != '_torch_common.py'}
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add((node.module or '').split('.')[0])
    assert not roots & ({'jax', 'jaxlib', 'victor_tpu'} | jax_side), roots
    assert 'victor_tpu_torch' in roots or path.endswith(
        'make_notebooks_torch.py')


# ---------------------------------------------------------------------------
# the tools: plot_chains, plot_scan, make_notebooks
# ---------------------------------------------------------------------------

@pytest.fixture()
def chain_root(tmp_path):
    """A chain root written by the port's chain writer: 4 GetDist files of
    a seeded 4-parameter chain with a derived chi2 column, and a
    .progress file of 3 rows."""
    from victor_tpu_torch.sampling import chains
    from victor_tpu_torch.sampling.priors import ParamSpace
    space = ParamSpace(tinf.PARAMS_BLOCK)
    rng = np.random.default_rng(3)
    mean = np.array([0.57, 0.367, 418.0, 1.009])
    std = np.array([0.054, 0.011, 44.0, 0.011])
    chain = mean + std * rng.standard_normal((200, 16, 4))
    lnp = -0.5 * (((chain - mean) / std) ** 2).sum(-1)
    aux = (-2 * lnp)[..., None]
    root = str(tmp_path / 'chains' / 'boss')
    chains.export_getdist(root, space, chain, lnp, aux,
                          aux_names=['chi2_ccf_correct'], burn_in=20,
                          n_chain_files=4)
    for i, (n, acc, rm1) in enumerate([(100, 0.31, 0.2), (200, 0.3, 0.05),
                                       (300, 0.29, 0.008)]):
        chains.append_progress(root, n, acc, rm1, reset=i == 0)
    return root


def test_plot_chains_matches_original(chain_root):
    """The port's statistics lines equal tools/plot_chains.py's on the same
    chain root, and both figures are drawn (matplotlib, Agg)."""
    argv = [chain_root, '--burn', '0.3', '--progress']
    _, want = _run(jchains.main, jax_argv=['plot_chains.py'] + argv)
    for suffix in ('_corner.png', '_progress.png'):
        os.remove(chain_root + suffix)
    _, got = _run(tchains.main, argv)
    assert got == want
    assert got[1].startswith('4 chain file(s), ')
    for suffix in ('_corner.png', '_progress.png'):
        assert os.path.getsize(chain_root + suffix) > 0


def test_plot_chains_without_matplotlib(chain_root, monkeypatch):
    """Where matplotlib is absent (the card's machine) the statistics are
    printed, the figures said to be skipped, and no PNG is written."""
    monkeypatch.setattr(tchains, 'have_matplotlib', lambda: False)
    _, got = _run(tchains.main, [chain_root, '--progress'])
    assert got[0] == 'progress plot: skipped: matplotlib is not installed'
    assert got[-1] == 'corner plot: skipped: matplotlib is not installed'
    assert [ln.split()[0] for ln in got[2:7]] == NAMES + ['chi2_ccf_correct']
    assert not [f for f in os.listdir(os.path.dirname(chain_root))
                if f.endswith('.png')]


def _strip_magics(src):
    return '\n'.join(ln for ln in src.splitlines()
                     if not ln.lstrip().startswith('%'))


def test_make_notebooks_no_execute(tmp_path, capsys):
    """`--no-execute` writes both notebooks; every code cell parses once
    its % magics are stripped; no cell names jax, victor_tpu (but its
    port) or a TPU; every cell that calls the port passes DEVICE."""
    import nbformat
    written = tnb.main(['--no-execute', '--device', 'cpu', '--out',
                        str(tmp_path)])
    assert [os.path.basename(p) for p in written] == [
        'victor_tpu_torch_usage_demo.ipynb', 'model_options_demo_torch.ipynb']
    calls = ('CCFFit(', 'CCFModel(', 'find_map(', 'run_smc(',
             'run_hmc_mcmc(')
    for path in written:
        nb = nbformat.read(path, as_version=4)
        assert nb.cells[0].cell_type == 'markdown'
        code = [c.source for c in nb.cells if c.cell_type == 'code']
        assert "DEVICE = 'cpu'" in code[0]
        for cell in nb.cells:
            assert not re.search(r'\bjax\b|\bvictor_tpu\b|\bTPU\b',
                                 cell.source, flags=re.IGNORECASE), cell.source
        for src in code:
            ast.parse(_strip_magics(src))
            for call in calls:
                for i in [m.start() for m in re.finditer(re.escape(call),
                                                         src)]:
                    stmt = src[i:src.find(')\n', i) + 1 or None]
                    assert 'device=DEVICE' in stmt, stmt
    assert capsys.readouterr().out.count('wrote ') == 2


def test_notebook_cells_mirror_original():
    """The port's notebooks keep the original's cells, one for one: the
    same kinds of cell in the same order."""
    import make_notebooks as jnb
    for jbuild, tbuild in ((jnb.usage_notebook, tnb.usage_notebook),
                           (jnb.options_notebook, tnb.options_notebook)):
        jcells, tcells = jbuild().cells, tbuild('cuda').cells
        assert [c.cell_type for c in tcells] == [c.cell_type for c in jcells]


# ---------------------------------------------------------------------------
# chip_smoke.py's EXAMPLE_GOLDENS
# ---------------------------------------------------------------------------

def _goldens_close(got, want, rtol):
    for key, value in want.items():
        g, w = np.asarray(got[key], dtype=float), np.asarray(value,
                                                             dtype=float)
        assert g.shape == w.shape, key
        assert _rel(g, w) <= rtol, key


def test_chip_smoke_example_goldens(jax_options, jax_usage, port_options,
                                    port_usage):
    """EXAMPLE_GOLDENS (phase 18a) as victor_tpu computes them at full
    width in f64: the tour's 20 (lnL, chi2), the usage checkpoints,
    multipoles and xi(5, 5), the multi-quantile walkthrough's numbers and
    the Fisher sigmas at FIT_GOLDENS' MAP (1e-12); the port's on the CPU
    meet 18a's bounds."""
    import victor_tpu.io
    import victor_tpu.sampling as js
    (golden, fit) = _literals('EXAMPLE_GOLDENS', 'FIT_GOLDENS')
    _, jvalues = jax_options
    want = {'model_options': jvalues,
            'usage_checkpoints': jax_usage['checkpoints'],
            'usage_monopole': jax_usage['multipoles']['0'].tolist(),
            'usage_quadrupole': jax_usage['multipoles']['2'].tolist(),
            'usage_xi_5_5': jax_usage['xi_5_5']}
    _, joint = jax_multiquantile(narrow=False)
    want.update({f'joint_{k}': v for k, v in joint.items()})
    cfg = tinf.load_config('boss_config.yaml')
    jb = victor_tpu.io.build_tables(copy.deepcopy(cfg['model']),
                                    copy.deepcopy(cfg['data']))
    theta = dict(zip(NAMES, fit['theta']))
    fr = js.fisher_forecast(jb, theta, NAMES)
    want['map_fisher_std'] = [fr.std[n] for n in NAMES]
    _goldens_close(want, {k: golden[k] for k in want}, 1e-12)

    _, rows = port_options
    out, _ = port_usage
    port = {'model_options': [[lnl, chi2] for _, lnl, chi2 in rows],
            'usage_checkpoints': [list(v) for v in
                                  out['checkpoints'].values()],
            'usage_xi_5_5': out['xi_5_5']}
    _goldens_close(port, {k: golden[k] for k in port}, 1e-9)
    from victor_tpu_torch.io import build_tables
    from victor_tpu_torch.sampling import fisher_forecast
    tb = build_tables(copy.deepcopy(cfg['model']),
                      copy.deepcopy(cfg['data']), device='cpu')
    fr = fisher_forecast(tb, theta, NAMES)
    assert _rel([fr.std[n] for n in NAMES], golden['map_fisher_std']) <= 1e-6
