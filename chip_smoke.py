#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py [--profile PATH]

Phases, each of which must pass (any failure exits non-zero before the
result line is printed):

1. print torch/CUDA versions and the card's name and power limit; require a
   CUDA device; pin TF32 off;
2. build the CUDA kernel from victor_tpu_torch/kernels/csrc with nvcc;
3. hold the kernel against its plain PyTorch version at the main path's
   shapes, in f64 and f32, with clamp on and off, on queries that mix
   out-of-range, on-knot, NaN and infinite values; time both with CUDA events;
4. run the batched BOSS DR12 CMASS likelihood (configs/boss_config.yaml,
   exact perf modes, f64, chunk 64) at the notebook golden point and the 50
   reference grid points of tests/fixtures/reference_boss.npz, and check
   that the kernel carried it;
5. time 4096 parameter points (for information).

The last two lines are a JSON summary of the kernels and the result line
{"ok": true, "device": {...}}. `--profile PATH` also writes a
torch.profiler summary of one timed batch to PATH.
"""

import argparse
import json
import os
import subprocess
import sys
import time



class _NoJax:
    """Import hook that refuses jax: the port must run without it."""

    def find_spec(self, name, path=None, target=None):
        if name == 'jax' or name.startswith('jax.'):
            raise ImportError(f'{name}: chip_smoke.py runs without jax')
        return None


sys.meta_path.insert(0, _NoJax())
REPO = os.path.dirname(os.path.abspath(__file__))

NAMES = ['fsigma8', 'beta', 'sigma_v', 'epsilon']
EXACT = {'streaming_eval': 'exact', 'beta_covariance': 'exact'}
GOLDEN = [0.47, 0.37, 380.0, 1.0]
GOLDEN_CHI2, GOLDEN_LNL = 65.01, 284.76
CHUNK = 64
N_POINTS = 150_000            # n_v * n_mu * n_s at BOSS size
TOL = {'float64': 1e-12, 'float32': 1e-5}


def check(ok, what):
    if not ok:
        raise RuntimeError(f'chip_smoke: check failed: {what}')
    print(f'  ok: {what}', flush=True)


def boss_config():
    """configs/boss_config.yaml, reading the .npz copies of its HDF5 files
    (data/BOSS_DR12_CMASS_npz): the script must run where h5py is absent."""
    import yaml
    with open(os.path.join(REPO, 'configs', 'boss_config.yaml')) as f:
        cfg = yaml.safe_load(f)

    def npz(path):
        name = os.path.splitext(os.path.basename(path))[0] + '.npz'
        return os.path.join('data', 'BOSS_DR12_CMASS_npz', name)

    model, data = cfg['model'], cfg['data']
    model['input_model_data_file'] = npz(model['input_model_data_file'])
    for block in ('redshift_space_ccf', 'covariance_matrix'):
        data[block]['data_file'] = npz(data[block]['data_file'])
    model['dir'] = data['dir'] = REPO
    return cfg


def card_line():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps=20):
    """Mean milliseconds per call over `reps` calls, timed with CUDA events
    after two warm-up calls."""
    import torch
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare_case(n, batch_coeffs, dtype, clamp, gen):
    """One kernel-vs-plain comparison at (64, 150000) queries; returns
    (max_abs_err, kernel ms, plain ms)."""
    import numpy as np
    import torch
    from victor_tpu_torch.kernels.ppoly import ppoly_eval_cuda, ppoly_eval_plain
    from victor_tpu_torch.ops.splines import Spline1D

    B, M = CHUNK, N_POINTS
    rng = np.random.default_rng(n + 7 * batch_coeffs + 3 * clamp)
    x_np = np.concatenate([[0.01], np.sort(rng.uniform(2.0, 120.0, n - 1))])
    spline = Spline1D.build(x_np, device='cuda', dtype=torch.float64)
    rows = B if batch_coeffs else 1
    y = torch.as_tensor(rng.standard_normal((rows, n)), device='cuda')
    coeffs = spline.coeffs(y).to(dtype).contiguous()
    x = spline.x.to(dtype)
    span = float(x_np[-1] - x_np[0])
    q = torch.rand((B, M), generator=gen, device='cuda', dtype=torch.float64)
    q = (x_np[0] - 0.1 * span + 1.2 * span * q).to(dtype)
    flat = q.view(-1)
    on_knot = torch.randint(0, B * M, (4096,), generator=gen, device='cuda')
    flat[on_knot] = x[torch.randint(0, n, (4096,), generator=gen,
                                    device='cuda')]
    q[:, :n] = x
    q[:, n] = float('nan')
    q[:, n + 1] = float('inf')
    q[:, n + 2] = float('-inf')
    if not batch_coeffs:
        q = q.reshape(1, -1)     # as ops.ppoly_eval passes a shared table

    out_k = ppoly_eval_cuda(x, coeffs, q, clamp)
    out_p = ppoly_eval_plain(x, coeffs, q, clamp)
    torch.cuda.synchronize()
    label = (f'n={n} coeffs=({rows},{n - 1},4) q={tuple(q.shape)} '
             f'{str(dtype)[6:]} clamp={clamp}')
    check(torch.equal(torch.isnan(out_k), torch.isnan(out_p)) and
          torch.equal(torch.isinf(out_k), torch.isinf(out_p)),
          f'{label}: NaN and inf positions identical')
    fin = torch.isfinite(out_p)
    err = float((out_k - out_p)[fin].abs().max())
    scale = float(out_p[fin].abs().max())
    tol = TOL[str(dtype)[6:]] * scale
    check(err <= tol, f'{label}: max|kernel - plain| = {err:.3e} <= {tol:.3e}')

    def kernel():
        ppoly_eval_cuda(x, coeffs, q, clamp)

    def plain():
        ppoly_eval_plain(x, coeffs, q, clamp)

    # in turns (kernel, plain, plain, kernel) so drift hits both alike
    k1, p1, p2, k2 = cuda_ms(kernel), cuda_ms(plain), cuda_ms(plain), cuda_ms(kernel)
    ms_k, ms_p = (k1 + k2) / 2, (p1 + p2) / 2
    print(f'  {label}: kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms', flush=True)
    return err, ms_k, ms_p


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--profile', metavar='PATH',
                        help='write a torch.profiler summary of one timed '
                             'batch to PATH')
    args = parser.parse_args()

    import numpy as np
    import torch

    # ---- 1. environment ----
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'python {sys.version.split()[0]}', flush=True)
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device (torch.cuda.is_available() is '
              'False)', file=sys.stderr)
        return 1
    card = card_line()
    print(f'card: {card}', flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    sys.path.insert(0, REPO)
    from victor_tpu_torch.io.tables import build_tables
    from victor_tpu_torch.kernels import _build, ppoly
    from victor_tpu_torch.likelihood.batched import make_batched_loglike

    # ---- 2. build the kernel ----
    t0 = time.perf_counter()
    lib = _build.build('ppoly_eval')
    build_s = time.perf_counter() - t0
    print(f'build: {lib.name} in {build_s:.2f} s', flush=True)
    print(lib.with_suffix('.log').read_text().strip(), flush=True)

    # ---- 3. kernel vs plain at the main path's shapes ----
    print('compare ppoly_eval kernel vs plain:', flush=True)
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    results = {}
    for dtype in (torch.float64, torch.float32):
        # v_r (31 knots) and xi_0 (30) have per-point coefficients; sigma_v
        # (25 knots, clamp off after Bicubic2D's own clamp) has one table
        for n, batched, clamp in ((31, True, True), (31, True, False),
                                  (30, True, True), (25, False, False)):
            results[(str(dtype)[6:], n, batched, clamp)] = compare_case(
                n, batched, dtype, clamp, gen)

    # ---- 4. the main path, f64 ----
    cfg = boss_config()
    t0 = time.perf_counter()
    bundle = build_tables(cfg['model'], cfg['data'], device='cuda',
                          dtype=torch.float64)
    print(f'build_tables: {time.perf_counter() - t0:.2f} s', flush=True)
    loglike = make_batched_loglike(bundle, NAMES, opts_kw=EXACT, chunk=CHUNK)
    ref = np.load(os.path.join(REPO, 'tests', 'fixtures', 'reference_boss.npz'))
    grid = ref['grid_params']

    ppoly.LAUNCHES = 0
    lnl_g, chi_g = loglike([GOLDEN])
    lnl, chi = loglike(grid)
    torch.cuda.synchronize()
    launches = ppoly.LAUNCHES
    chunks = 1 + -(-len(grid) // CHUNK)
    print('main path:', flush=True)
    check(lnl_g.shape == (1,) and lnl.shape == chi.shape == (len(grid),),
          'output shapes')
    check(bool(torch.isfinite(lnl).all() and torch.isfinite(chi).all()),
          'finite outputs')
    chi2_0, lnl_0 = float(chi_g[0]), float(lnl_g[0])
    check(abs(chi2_0 - GOLDEN_CHI2) < 0.01 and abs(lnl_0 - GOLDEN_LNL) < 0.01,
          f'golden point chi2 {chi2_0:.6f} (65.01), lnL {lnl_0:.6f} (284.76)')
    d_chi = float(np.abs(chi.cpu().numpy() - ref['grid_chi2']).max())
    d_lnl = float(np.abs(lnl.cpu().numpy() - ref['grid_lnl']).max())
    check(d_chi < 1e-8 and d_lnl < 1e-8,
          f'50 reference grid points: max |d chi2| {d_chi:.3e}, '
          f'max |d lnL| {d_lnl:.3e} (< 1e-8)')
    check(launches >= 3 * chunks,
          f'ppoly_eval kernel launches on the main path: {launches} '
          f'(>= 3 per chunk, {chunks} chunks)')

    # ---- 5. throughput (information only) ----
    rng = np.random.default_rng(0)
    n = 4096
    theta = torch.as_tensor(np.column_stack([
        rng.uniform(0.3, 0.6, n), rng.uniform(0.25, 0.55, n),
        rng.uniform(250.0, 450.0, n), rng.uniform(0.9, 1.1, n)]),
        device='cuda')
    loglike(theta)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        loglike(theta)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    rate = 3 * n / sum(times)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f'throughput: {rate:.1f} evals/s (f64, {n} points, chunk {CHUNK}, '
          f'reps {[round(t, 4) for t in times]} s, peak {peak_gb:.2f} GB) '
          f'on {card}', flush=True)

    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            loglike(theta)
            torch.cuda.synchronize()
        table = prof.key_averages().table(sort_by='cuda_time_total',
                                          row_limit=40)
        os.makedirs(os.path.dirname(os.path.abspath(args.profile)),
                    exist_ok=True)
        with open(args.profile, 'w') as f:
            f.write(f'{card}\n{n} points, chunk {CHUNK}, f64\n{table}\n')
        print(table, flush=True)

    key = ('float64', 31, True, True)
    print(f'card: {card}', flush=True)
    print(json.dumps({'kernels': [{
        'name': 'ppoly_eval', 'route': 'cuda',
        'source': 'victor_tpu_torch/kernels/csrc/ppoly_eval.cu',
        'replaces': 'victor_tpu/ops/splines.py:537',
        'launches': launches, 'max_abs_err': results[key][0],
        'ms': results[key][1], 'plain_ms': results[key][2]}]}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
