"""Run `distributed_init`'s multi-process branch end to end.

    python -m victor_tpu_torch.parallel.probe [--device cuda|cpu]
        [--backend gloo|nccl] [--timeout SECONDS] [--n-mu N --n-v N]

It runs on the card unless `--device cpu` is given, as every entry point of
the port does; without a CUDA device the default exits non-zero, naming
`--device cpu`.

The counterpart of tools/distributed_probe.py. The reference's multi-host
story is `mpirun -n N cobaya-run`, N cooperating processes
(victor/README.md:30). The parent starts two processes on a 127.0.0.1
coordinator; process i

1. joins the group: `distributed_init(coordinator, num_processes=2,
   process_id=i)`;
2. builds the BOSS bundle (configs/boss_config.yaml, the .npz copies of its
   data) on its device: the card i modulo the card count, or with
   `--device cpu` the CPU;
3. evaluates its half of a 32-point theta batch, the batch's walkers axis
   split one device per process, through `make_sharded_loglike` on a mesh
   of its own device, and holds it against its own unsharded evaluation of
   the whole batch (1e-12 relative); then gathers both halves through an
   all_gather and holds the gathered batch against the same values;
4. runs `cross_chain_rhat` with four chains split two per process, the
   per-chain statistics gathered through real collectives, against the
   single-process value (1e-12).

Each process prints one JSON line (its ppoly_eval kernel launches among
them), the parent prints them and a summary line, and exits non-zero on a
failure or timeout. NCCL refuses two ranks on one card ("Duplicate GPU
detected"): processes that share a card use gloo, which gathers host copies
of the CUDA tensors; a process that owns its card can use NCCL.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
NAMES = ['fsigma8', 'beta', 'sigma_v', 'epsilon']
N_PER_PROCESS = 16


def boss_config() -> dict:
    """configs/boss_config.yaml on the .npz copies of its data files
    (data/BOSS_DR12_CMASS_npz), which need no h5py."""
    import yaml
    with open(REPO / 'configs' / 'boss_config.yaml') as f:
        cfg = yaml.safe_load(f)
    npz = REPO / 'data' / 'BOSS_DR12_CMASS_npz'
    model, data = cfg['model'], cfg['data']
    model['input_model_data_file'] = str(
        npz / (Path(model['input_model_data_file']).stem + '.npz'))
    for block in ('redshift_space_ccf', 'covariance_matrix'):
        data[block]['data_file'] = str(
            npz / (Path(data[block]['data_file']).stem + '.npz'))
    model['dir'] = data['dir'] = str(REPO)
    return cfg


def child(args) -> int:
    import numpy as np
    import torch
    import torch.distributed as dist

    from ..io.tables import build_tables
    from ..likelihood.batched import (make_batched_loglike,
                                      make_sharded_loglike)
    from ..utils.profiling import total
    from .mesh import (_all_gather, cross_chain_rhat, distributed_init,
                       make_mesh)

    rank, n_proc = args.process_id, args.num_processes
    distributed_init(args.coordinator, num_processes=n_proc,
                     process_id=rank, backend=args.backend)
    if args.device == 'cuda':
        device = torch.device('cuda', rank % torch.cuda.device_count())
    else:
        device = torch.device('cpu')
        torch.set_num_threads(1)
    cfg = boss_config()
    bundle = build_tables(cfg['model'], cfg['data'], n_mu=args.n_mu,
                          n_v=args.n_v, device=device)

    # --- 1. the likelihood batch, split one device per process ----------
    n = N_PER_PROCESS * n_proc
    rng = np.random.default_rng(0)                 # the same everywhere
    theta = np.column_stack([
        rng.uniform(0.3, 0.6, n), rng.uniform(0.25, 0.55, n),
        rng.uniform(250.0, 450.0, n), rng.uniform(0.9, 1.1, n)])
    mine = slice(rank * N_PER_PROCESS, (rank + 1) * N_PER_PROCESS)
    mesh = make_mesh(('walkers',), devices=[device])
    sharded = make_sharded_loglike(bundle, NAMES, mesh, gradient_free=False)
    before = total('ppoly.launches', device)
    lnl, chi2 = sharded(theta[mine])
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    launches = total('ppoly.launches', device) - before
    ref_lnl, ref_chi2 = make_batched_loglike(bundle, NAMES,
                                             gradient_free=False)(theta)
    finite = bool(torch.isfinite(ref_lnl).all())
    shard_ok = bool(torch.allclose(lnl, ref_lnl[mine], rtol=1e-12, atol=0)
                    and torch.allclose(chi2, ref_chi2[mine], rtol=1e-12,
                                       atol=0))
    shard_bit = bool(torch.equal(lnl, ref_lnl[mine]))
    gathered = _all_gather(lnl, dist.group.WORLD).flatten()
    gather_ok = bool(torch.allclose(gathered, ref_lnl, rtol=1e-12, atol=0))

    # --- 2. Gelman-Rubin with the chains split across processes ---------
    chains = torch.as_tensor(
        rng.standard_normal((2 * n_proc, 200, len(NAMES)))
        + rng.uniform(-0.1, 0.1, (2 * n_proc, 1, len(NAMES))), device=device)
    rhat = cross_chain_rhat(chains[2 * rank:2 * rank + 2],
                            group=dist.group.WORLD)
    rhat_ref = cross_chain_rhat(chains)
    rhat_ok = bool(torch.allclose(rhat, rhat_ref, rtol=1e-12, atol=1e-12))

    ok = (dist.get_world_size() == n_proc and finite and shard_ok
          and gather_ok and rhat_ok)
    print(json.dumps({
        'child': rank, 'ok': ok, 'world_size': dist.get_world_size(),
        'device': str(device), 'backend': dist.get_backend(),
        'likelihood_shard_matches': shard_ok,
        'likelihood_shard_bit_equal': shard_bit,
        'likelihood_gather_matches': gather_ok,
        'rhat_cross_process_matches': rhat_ok,
        'rhat_max': float(rhat.max()), 'ppoly_eval_launches': launches,
    }), flush=True)
    dist.destroy_process_group()
    return 0 if ok else 1


def parent(args) -> int:
    t0 = time.perf_counter()
    if args.device == 'cuda':
        import torch
        if not torch.cuda.is_available():
            print('probe: no CUDA device; pass --device cpu to run the probe '
                  'on the host', file=sys.stderr, flush=True)
            return 2
    with socket.socket() as s:                     # a free localhost port
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    common = ['--coordinator', f'127.0.0.1:{port}', '--num-processes',
              str(args.num_processes), '--device', args.device,
              '--backend', args.backend, '--n-mu', str(args.n_mu),
              '--n-v', str(args.n_v)]
    procs = [subprocess.Popen(
        [sys.executable, '-m', 'victor_tpu_torch.parallel.probe', '--child',
         '--process-id', str(i)] + common,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO) for i in range(args.num_processes)]
    deadline = time.monotonic() + args.timeout
    outs, lines, fails = [], [], 0
    for p in procs:
        try:
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            out += '\n[parent] TIMEOUT'
        outs.append(out)
        json_lines = [ln for ln in out.splitlines() if ln.startswith('{')]
        if p.returncode != 0 or not json_lines:
            fails += 1
        else:
            lines.append(json.loads(json_lines[-1]))
    for out in outs:
        # each child's JSON line; everything it printed on a failure
        tail = [ln for ln in out.splitlines() if ln.startswith('{')]
        print(tail[-1] if tail and not fails else out, flush=True)
    print(json.dumps({
        'check': 'distributed_init_two_process', 'ok': fails == 0,
        'n_processes': args.num_processes, 'device': args.device,
        'backend': args.backend,
        'ppoly_eval_launches': sum(c['ppoly_eval_launches'] for c in lines),
        'seconds': round(time.perf_counter() - t0, 2)}), flush=True)
    return 0 if fails == 0 else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog='python -m victor_tpu_torch.parallel.probe',
        description=__doc__.split('\n')[0])
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    ap.add_argument('--backend', choices=('gloo', 'nccl'), default='gloo')
    ap.add_argument('--timeout', type=float, default=600.0,
                    help='seconds for both processes together')
    ap.add_argument('--n-mu', type=int, default=100,
                    help='mu grid of the tables (build_tables; 100 is the '
                         'full width)')
    ap.add_argument('--n-v', type=int, default=50,
                    help='velocity grid of the tables (50 is the full width)')
    ap.add_argument('--num-processes', type=int, default=2)
    ap.add_argument('--child', action='store_true', help=argparse.SUPPRESS)
    ap.add_argument('--process-id', type=int, help=argparse.SUPPRESS)
    ap.add_argument('--coordinator', help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    return child(args) if args.child else parent(args)


if __name__ == '__main__':
    sys.exit(main())
