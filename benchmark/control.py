#!/usr/bin/env python3
"""Readings for the limits of a cell's compared numbers, on the card(s).

    python3 benchmark/control.py --workload <name> --seeds 11 12 13 --seconds 10

For each seed, in one process: the cell's set-up (the program's tables
built once for all seeds) and a window of --seconds, then the compared
numbers: the program against the float64 reference (the lower readings),
and on the first --control-seeds seeds the control, the reference computed
in float32 put in the program's place at the same recorded states, against
the float64 reference (the upper readings). One JSON line per seed. The
benchmark's own runs do not run this.
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import run  # sets the caches, the threads and sys.path


def _spread(drv):
    """Where the check replays positions (HMC): the quantiles of the rows'
    relative position gaps, and how many rows exceed each power of ten."""
    gaps = getattr(drv, 'position_gaps', None)
    if not gaps:
        return None
    import torch
    g = torch.cat(gaps)
    q = torch.tensor([0.5, 0.9, 0.99, 1.0], dtype=g.dtype)
    return {'quantiles': torch.quantile(g, q).tolist(),
            'above': {f'1e-{k}': int((g > 10.0 ** -k).sum())
                      for k in range(2, 11)}, 'rows': int(g.numel())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--seconds', type=float, default=10.0)
    ap.add_argument('--control-seeds', type=int, default=None,
                    help='run the control on the first N seeds (all)')
    ap.add_argument('--one-card', action='store_true',
                    help="a cell's traffic on one card, without its mesh: "
                         'run_smc keeps the particles, the resampling and '
                         'the generator on one card, so the draws are the '
                         "cell's own; for the control's readings")
    ap.add_argument('--device', default='cuda',
                    help="'cpu' runs it on the host, for a test")
    args = ap.parse_args(argv)

    import torch
    torch.set_num_threads(int(run.THREADS))

    import reference
    from benchlib import drivers
    from benchlib.manifest import find_cell

    cell = find_cell(args.workload)
    if args.one_card:
        cell.chips = 1
    device = torch.device(args.device)
    if device.type == 'cuda' and torch.cuda.device_count() < cell.chips:
        print(f'{args.workload} needs {cell.chips} CUDA device(s)',
              file=sys.stderr)
        return 2
    ref64 = reference.build(cell.config, device)
    ref32 = reference.build(cell.config, device, torch.float32)
    tables = drivers.program_bundle(cell.config, device)
    n_control = len(args.seeds) if args.control_seeds is None \
        else args.control_seeds
    for k, seed in enumerate(args.seeds):
        with tempfile.TemporaryDirectory(prefix='bench_') as scratch:
            drv = drivers.driver(cell, seed, device, Path(scratch), tables)
            drv.setup()
            w = drv.window(args.seconds)
            drv.free()
            t = time.perf_counter()
            out = {'workload': cell.name, 'seed': seed,
                   'rate': w['units'] / w['seconds'],
                   'program': drv.check(ref64)}
            out['check_s'] = time.perf_counter() - t
            out['program_positions'] = _spread(drv)
            if k < n_control:
                out['control'] = drv.check(ref64, cand=ref32)
                out['control_positions'] = _spread(drv)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
