"""The manifest and the files it names are found by name, and a cell, a
configuration, a traffic mix or a metric is added as new files and new
manifest entries alone."""

import json
import re
import shutil

import pytest

from benchlib import manifest

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.\-]{1,16}$')


def _cells():
    return [w['name'] for w in manifest.load_manifest()['workloads']]


def test_manifest_keys_and_names():
    b = manifest.load_manifest()
    assert set(b) == {'command', 'paths', 'run_seconds', 'configs',
                      'workloads', 'end_to_end', 'per_layer'}
    names = [x['name'] for k in ('configs', 'workloads', 'end_to_end',
                                 'per_layer') for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m['unit']) for k in ('end_to_end', 'per_layer')
               for m in b[k])
    e2e = {m['name'] for m in b['end_to_end']}
    assert 'setup_s' in e2e
    assert all(m['moves'] in e2e for m in b['per_layer'])
    assert all((manifest.ROOT / c['file']).is_file() for c in b['configs'])
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize('name', _cells())
def test_every_cell_finds_its_files(name):
    cell = manifest.find_cell(name)
    assert cell.traffic['sampler'] in ('smc', 'hmc')
    assert cell.config['modes'][cell.traffic['sampler']]
    assert {m['name'] for m in cell.end_to_end} >= {'setup_s'}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    assert all(isinstance(v, float) for v in cell.limits.values())
    for m in cell.end_to_end + cell.per_layer:
        assert callable(manifest.metric_reader(m['name']))


def test_a_cell_added_as_new_files_only(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    cell, its limits and a per-layer metric without any file of the copy
    being edited, apart from the manifest's new entries."""
    shutil.copytree(manifest.BENCH_DIR, tmp_path / manifest.BENCH_DIR.name,
                    ignore=shutil.ignore_patterns('__pycache__'))
    b = manifest.load_manifest()
    bench = tmp_path / manifest.BENCH_DIR.name
    before = {p: p.read_bytes() for p in bench.rglob('*') if p.is_file()}
    shutil.copy(bench / 'configs' / 'boss_dr12_streaming.yaml',
                bench / 'configs' / 'boss_dr12_other.yaml')
    (bench / 'traffic' / 'smc_small.yaml').write_text(
        'sampler: smc\nn_particles: 512\nn_moves: 3\ness_target: 0.5\n'
        'chunk: 64\ncheck_stages: 1\n')
    (bench / 'limits' / 'other_smc.yaml').write_text(
        'lnl_gap: 1.0e-6\nmoved_apart: 0.01\n')
    (bench / 'metrics' / 'stage_s.other.py').write_text(
        'def read(run):\n    return run.window_s\n')
    b['configs'].append(dict(b['configs'][0], name='boss_dr12_other',
                             file='benchmark/configs/boss_dr12_other.yaml'))
    b['workloads'].append({'name': 'other_smc', 'config': 'boss_dr12_other',
                           'traffic': 'smc_small', 'chips': 1, 'why': 'x'})
    for m in b['end_to_end']:
        if m['name'] == 'evals_per_s':
            m['workloads'].append('other_smc')
    b['per_layer'].append({'name': 'stage_s.other', 'unit': 's',
                           'better': 'lower', 'source': 'host_clock',
                           'layer': 'sampler', 'moves': 'evals_per_s',
                           'workloads': ['other_smc']})
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(b))

    cell = manifest.find_cell('other_smc', root=tmp_path)
    assert cell.traffic['n_particles'] == 512
    assert cell.config_name == 'boss_dr12_other'
    assert [m['name'] for m in cell.per_layer] == ['stage_s.other']
    assert {m['name'] for m in cell.end_to_end} == {'evals_per_s', 'setup_s'}
    run = type('Run', (), {'window_s': 30.5})()
    assert manifest.metric_reader('stage_s.other', root=tmp_path)(run) == 30.5
    # the old cells are untouched by the addition
    assert manifest.find_cell('boss_smc', root=tmp_path).per_layer == \
        manifest.find_cell('boss_smc').per_layer
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_a_suffixed_metric_falls_back_to_its_shared_reader(tmp_path):
    """`<name>.<suffix>` reads its own file where there is one, and the
    quantity's shared `<name>.py` where there is not."""
    metrics = tmp_path / manifest.BENCH_DIR.name / 'metrics'
    metrics.mkdir(parents=True)
    (metrics / 'rate.py').write_text('def read(run):\n    return 1.0\n')
    (metrics / 'rate.own.py').write_text('def read(run):\n    return 2.0\n')
    assert manifest.metric_reader('rate.other', root=tmp_path)(None) == 1.0
    assert manifest.metric_reader('rate.own', root=tmp_path)(None) == 2.0
    assert manifest.metric_reader('rate', root=tmp_path)(None) == 1.0


def test_unknown_cell_is_named():
    with pytest.raises(KeyError, match='no workload'):
        manifest.find_cell('no_such_cell')
