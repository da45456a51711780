"""On the card, at each cell's own size with a short window: the program's
compared numbers lie within their limits, and the control's, the reference
computed in float32 in the program's place, do not (at least one of them).
`python3 benchmark/control.py` reads the same numbers over many seeds; the
limits were set from its readings (PERF.md). On the CPU, at a tiny size,
control.py and stage_overhead.py run through."""

import tempfile
from pathlib import Path

import pytest
import torch

import reference
from benchlib import drivers, manifest

CELLS = [w['name'] for w in manifest.load_manifest()['workloads']]


@pytest.mark.cuda
@pytest.mark.parametrize('name', CELLS)
def test_the_control_fails_where_the_program_passes(name, card):
    cell = manifest.find_cell(name)
    if torch.cuda.device_count() < cell.chips:
        pytest.skip(f'{name} needs {cell.chips} cards')
    ref64 = reference.build(cell.config, card)
    ref32 = reference.build(cell.config, card, torch.float32)
    with tempfile.TemporaryDirectory() as scratch:
        drv = drivers.driver(cell, 2 ** 31 + 5, card, Path(scratch))
        drv.setup()
        drv.window(5.0)
        drv.free()
        program = drv.check(ref64)
        control = drv.check(ref64, cand=ref32)
    assert all(program[k] <= cell.limits[k] for k in program), program
    assert any(control[k] > cell.limits[k] for k in control), control


def _tiny_cells(monkeypatch):
    """find_cell with each cell's traffic cut to conftest's sizes."""
    from conftest import SIZES
    real = manifest.find_cell

    def tiny(name, root=manifest.ROOT):
        cell = real(name, root)
        cell.traffic.update(SIZES[cell.traffic['sampler']])
        return cell
    monkeypatch.setattr(manifest, 'find_cell', tiny)


@pytest.mark.parametrize('name,extra', [('boss_smc', []), ('boss_hmc', []),
                                        ('boss_smc_4chip', ['--one-card'])])
def test_control_reads_both_sides_on_the_cpu(name, extra, monkeypatch,
                                             capsys):
    """control.py at a tiny size: one line per seed, the control on the
    first seed only, the program within its limits, HMC's position gaps."""
    import json

    import control
    _tiny_cells(monkeypatch)
    assert control.main(['--workload', name, '--seeds', '5', '2147483999',
                         '--seconds', '0.2', '--control-seeds', '1',
                         '--device', 'cpu'] + extra) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith('{')]
    assert [x['seed'] for x in lines] == [5, 2147483999]
    assert 'control' in lines[0] and 'control' not in lines[1]
    limits = manifest.find_cell(name).limits
    assert all(v <= limits[k] for x in lines for k, v in x['program'].items())
    assert (lines[0]['program_positions'] is None) == (name != 'boss_hmc')


def test_stage_overhead_on_the_cpu(monkeypatch, capsys):
    import json

    import stage_overhead
    _tiny_cells(monkeypatch)
    assert stage_overhead.main(['--workload', 'boss_smc', '--seed', '9',
                                '--stages', '2', '--device', 'cpu']) == 0
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert len(out['whole_s']) == len(out['staged_s']) == 2
    assert stage_overhead.main(['--workload', 'boss_hmc', '--seed', '9',
                                '--device', 'cpu']) == 2
