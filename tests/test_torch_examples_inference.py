"""The port's inference walkthrough (examples/inference_demo_torch.py)
against victor_tpu's (examples/inference_demo.py), beside
tests/test_torch_examples.py, which holds the other walkthroughs and tools.

On the CPU in f64 at the narrow width (n_mu 20, n_v 10, `build_tables`
patched in both example modules): the MAP of 16 starts, its Laplace
correlation and evidence, the Fisher sigmas at the MAP and the 13-point
profile's interval with chip_smoke.py phase 18a's tolerances; the port's
`scan` JSON over that profile through tools/plot_scan.py; and, slow,
EXAMPLE_GOLDENS' MAP numbers recomputed with victor_tpu at full width
(its 16-start fit and 13-point profile take minutes here).
"""

import functools
import json
import os
import sys

import numpy as np
import pytest

from test_torch_examples import (NAMES, NARROW, _literals, _recorder, _rel,
                                 _run, jinf, tinf)

@pytest.fixture(scope='module')
def jax_inference():
    import victor_tpu.io
    import victor_tpu.sampling as js
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(victor_tpu.io, 'build_tables',
                   functools.partial(victor_tpu.io.build_tables, **NARROW))
        seen = {name: _recorder(mp, js, name) for name in
                ('find_map', 'profile_scan', 'fisher_forecast')}
        _, lines = _run(jinf.main, jax_argv=['inference_demo.py'])
    return lines, {k: v[0] for k, v in seen.items()}


@pytest.fixture(scope='module')
def port_inference():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tinf, 'build_tables',
                   functools.partial(tinf.build_tables, **NARROW))
        return _run(tinf.main, ['--device', 'cpu'])


def test_inference_constants_equal_original():
    assert tinf.PARAMS_BLOCK == jinf.PARAMS_BLOCK
    (quad,) = _literals('QUAD_BLOCK')
    assert tinf.PARAMS_BLOCK == quad


def test_inference_demo_matches_victor_tpu(jax_inference, port_inference):
    """The MAP (theta within 1e-4 Laplace sigma, chi2 within 1e-6, the
    sigmas 1e-6), the Laplace correlation and evidence and the Fisher
    sigmas at the MAP (1e-6 relative), the profile's delta-chi2 = 1
    interval (1e-3 relative on each end: phase 18a's tolerances); the
    printed lines equal but |grad|'s."""
    jlines, j = jax_inference
    out, lines = port_inference
    m, jm = out['map'], j['find_map']
    sd = np.sqrt(np.diag(jm.cov))
    assert np.max(np.abs(m.theta - jm.theta) / sd) <= 1e-4
    assert abs(m.chi2 - jm.chi2) <= 1e-6
    assert _rel(np.sqrt(np.diag(m.cov)), sd) <= 1e-6
    assert m.grad_norm < 1e-6 and m.hessian_pd
    assert out['corr'] == pytest.approx(float(jm.correlation[0, 2]),
                                        rel=1e-6)
    assert out['lnz_laplace'] == pytest.approx(jm.log_evidence_laplace,
                                               rel=1e-6)
    assert _rel([out['fisher'].std[n] for n in NAMES],
                [j['fisher_forecast'].std[n] for n in NAMES]) <= 1e-6
    assert _rel(out['interval'], j['profile_scan'].interval(1.0)) <= 1e-3
    np.testing.assert_allclose(out['profile'].grid, j['profile_scan'].grid,
                               rtol=1e-6)

    def drop_grad(ls):
        return [ln for ln in ls if '|grad|' not in ln]
    assert drop_grad(lines) == drop_grad(jlines)
    assert lines[0] == '== best fit (MAP) ==' and len(lines) == 15


def test_port_scan_json_read_by_plot_scan(port_inference, tmp_path,
                                          monkeypatch, capsys):
    """`python -m victor_tpu_torch scan` prints JSON that tools/plot_scan.py
    reads unchanged: the port's CLI scan over the 13-point profile of the
    inference walkthrough (its profile_scan's result given back)."""
    import plot_scan
    import yaml

    import victor_tpu_torch.sampling.optimize as topt_mod
    from victor_tpu_torch.__main__ import main as tmain
    prof = port_inference[0]['profile']
    monkeypatch.setattr(topt_mod, 'profile_scan', lambda *a, **k: prof)
    cfg = tinf.load_config('boss_config.yaml')
    cfg['params'] = tinf.PARAMS_BLOCK
    path = tmp_path / 'cfg.yaml'
    path.write_text(yaml.safe_dump(cfg))
    monkeypatch.setattr(
        'victor_tpu_torch.__main__._build_bundle', lambda cfg, device: None)
    tmain(['scan', str(path), '--param', 'fsigma8', '--device', 'cpu'])
    out = json.loads(capsys.readouterr().out)
    assert out['scan'] == ['fsigma8'] and len(out['grid']) == 13
    scan_json = tmp_path / 'scan.json'
    scan_json.write_text(json.dumps(out))
    monkeypatch.setattr(sys, 'argv', ['plot_scan.py', str(scan_json)])
    plot_scan.main()
    png = str(tmp_path / 'scan.png')
    assert capsys.readouterr().out.strip() == png
    assert os.path.getsize(png) > 0


@pytest.mark.slow
def test_chip_smoke_example_map_goldens():
    """EXAMPLE_GOLDENS' MAP numbers: victor_tpu's inference walkthrough at
    full width (16 starts) lands on FIT_GOLDENS' optimum; its Laplace
    correlation and evidence and its 13-point profile interval."""
    import victor_tpu.sampling as js
    (golden, fit) = _literals('EXAMPLE_GOLDENS', 'FIT_GOLDENS')
    with pytest.MonkeyPatch.context() as mp:
        seen = {name: _recorder(mp, js, name)
                for name in ('find_map', 'profile_scan')}
        _run(jinf.main, jax_argv=['inference_demo.py'])
    m, prof = seen['find_map'][0], seen['profile_scan'][0]
    sd = np.array(fit['std'])
    assert np.max(np.abs(m.theta - fit['theta']) / sd) <= 1e-6
    assert abs(m.chi2 - fit['chi2']) <= 1e-8
    assert m.correlation[0, 2] == pytest.approx(golden['map_corr'],
                                                rel=1e-10)
    assert m.log_evidence_laplace == pytest.approx(
        golden['map_lnz_laplace'], rel=1e-10)
    np.testing.assert_allclose(prof.interval(1.0),
                               golden['profile_interval'], rtol=1e-8)
