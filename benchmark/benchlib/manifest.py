"""The benchmark's manifest and the files it names.

`BENCHMARK.json` at the checkout's root lists the cells (`workloads`), each
naming a configuration and a traffic mix, and the metrics. Everything that
belongs to one name sits in a file of its own, found by that name:

    benchmark/configs/<config>.yaml     sizes, modes, model, data, params
    benchmark/traffic/<traffic>.yaml    the sampler and its parameters
    benchmark/limits/<workload>.yaml    each compared number's limit
    benchmark/metrics/<metric>.py       the reader of one metric; a name
                                        with a suffix (`idle_pct.smc`) falls
                                        back to the quantity's shared reader
                                        (`idle_pct.py`) where it has no file

A configuration's file is the one `configs` names in the manifest; the
others follow from the name alone, so a cell, a traffic mix or a metric is
added as new files and new manifest entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

import yaml

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: Dict
    traffic_name: str
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]          # the manifest's entries this cell reports
    per_layer: List[Dict]


def load_manifest(root: Path = ROOT) -> Dict:
    with open(root / 'BENCHMARK.json') as f:
        return json.load(f)


def _yaml(path: Path) -> Dict:
    with open(path) as f:
        return yaml.safe_load(f)


def _resolve_files(node, root: Path):
    """The configuration with every relative `*_file` path taken from the
    checkout's root, so that a run reads the same files from any working
    directory."""
    if isinstance(node, dict):
        return {k: str(root / v) if k.endswith('_file') and isinstance(v, str)
                and not Path(v).is_absolute() else _resolve_files(v, root)
                for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve_files(v, root) for v in node]
    return node


def reports(metric: Dict, cell: Dict, manifest: Dict) -> bool:
    """Whether `cell` reports `metric`: the cells its `workloads` lists, or
    for a per-layer metric without the key every cell that reports the
    end-to-end metric it moves."""
    if 'workloads' in metric:
        return cell['name'] in metric['workloads']
    if 'moves' in metric:
        e2e = next(m for m in manifest['end_to_end']
                   if m['name'] == metric['moves'])
        return reports(e2e, cell, manifest)
    return True


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell called `name`, with its configuration, traffic and limits
    read from their files."""
    manifest = load_manifest(root)
    cells = {w['name']: w for w in manifest['workloads']}
    if name not in cells:
        raise KeyError(f'no workload {name!r} in BENCHMARK.json; there are '
                       f'{sorted(cells)}')
    w = cells[name]
    configs = {c['name']: c for c in manifest['configs']}
    bench = root / BENCH_DIR.name
    return Cell(
        name=name, chips=int(w['chips']),
        config_name=w['config'],
        config=_resolve_files(_yaml(root / configs[w['config']]['file']),
                              root),
        traffic_name=w['traffic'],
        traffic=_yaml(bench / 'traffic' / f"{w['traffic']}.yaml"),
        limits=_yaml(bench / 'limits' / f'{name}.yaml'),
        end_to_end=[m for m in manifest['end_to_end']
                    if reports(m, w, manifest)],
        per_layer=[m for m in manifest['per_layer']
                   if reports(m, w, manifest)])


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    """`read(run) -> float or None` of benchmark/metrics/<name>.py, or where
    there is no such file, of the file named without the name's last
    `.suffix`: one reader serves a quantity that cells report under names of
    their own (`evals_per_s.mesh` beside `evals_per_s`)."""
    metrics = root / BENCH_DIR.name / 'metrics'
    path = metrics / f'{name}.py'
    if not path.is_file() and '.' in name:
        path = metrics / f"{name.rsplit('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(
        'bench_metric_' + name.replace('.', '_'), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
