#!/usr/bin/env python3
"""What ending the SMC window at a stage boundary costs.

    python3 benchmark/stage_overhead.py --workload boss_smc --seed 7 --stages 4

The window calls `run_smc` once per stage (max_stages=1, a checkpoint and
resume=True), where a user's run calls it once. On the card(s), this times
one `run_smc` call of --stages stages against the same stages made one call
each, from the same seed (the same work: a resumed run is bit-identical),
in the order whole, staged, staged, whole, and prints one JSON line: each
time, and the median extra seconds per stage. The benchmark's own runs do
not run this.
"""

import argparse
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

import run  # sets the caches, the threads and sys.path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--stages', type=int, default=4)
    ap.add_argument('--device', default='cuda',
                    help="'cpu' runs it on the host, for a test")
    args = ap.parse_args(argv)

    import torch
    torch.set_num_threads(int(run.THREADS))

    from benchlib import drivers
    from benchlib.manifest import find_cell
    from victor_tpu_torch.sampling.smc import run_smc

    cell = find_cell(args.workload)
    device = torch.device(args.device)
    if cell.traffic['sampler'] != 'smc' or (
            device.type == 'cuda' and torch.cuda.device_count() < cell.chips):
        print(f'{args.workload}: an SMC cell on {cell.chips} card(s) is '
              'needed', file=sys.stderr)
        return 2
    t = cell.traffic
    with tempfile.TemporaryDirectory(prefix='bench_') as scratch:
        drv = drivers.driver(cell, args.seed, device, Path(scratch))
        drv.setup()

        def whole():
            try:
                run_smc(drv.bundle, cell.config['params'],
                        n_particles=int(t['n_particles']),
                        ess_target=float(t['ess_target']),
                        n_moves=int(t['n_moves']), seed=args.seed,
                        opts_kw=cell.config['modes']['smc'],
                        chunk=int(t['chunk']), max_stages=args.stages,
                        mesh=drv.mesh, device=drv.device)
            except RuntimeError as e:
                if 'did not reach beta=1' not in str(e):
                    raise

        def staged():
            ckpt = Path(scratch) / 'staged.npz'
            for _ in range(args.stages):
                if drv._call(args.seed, ckpt, int(t['n_moves'])):
                    break
            ckpt.unlink(missing_ok=True)

        times = {'whole': [], 'staged': []}
        for name, fn in (('whole', whole), ('staged', staged),
                         ('staged', staged), ('whole', whole)):
            t0 = time.perf_counter()
            fn()
            drivers.synchronize(drv.devices)
            times[name].append(time.perf_counter() - t0)
    extra = (statistics.median(times['staged'])
             - statistics.median(times['whole'])) / args.stages
    print(json.dumps({'workload': cell.name, 'stages': args.stages,
                      'whole_s': times['whole'], 'staged_s': times['staged'],
                      'extra_s_per_stage': extra,
                      'extra_share': extra * args.stages
                      / statistics.median(times['whole'])}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
