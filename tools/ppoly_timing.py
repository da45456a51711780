#!/usr/bin/env python3
"""Time the ppoly_eval kernel of one checkout of victor_tpu_torch on the card.

    python3 tools/ppoly_timing.py [--root DIR] [--mh] [--backward]
                                  [--second-order] [--out PATH]

Imports victor_tpu_torch from DIR (default: this repository), builds its
ppoly_eval kernel with nvcc and runs chip_smoke.py's ppoly_eval phases
against it: the main path's shapes (phase 3), the edge shapes (phase 3b),
every lookup of one MH step with L2 cold and warm, and rows shorter than a
tile ((8, 25), (8, 49), (64, 49)). Every time is device only
(`chip_smoke.device_ms`) beside the wrapper's host microseconds per call
(`chip_smoke.host_us`). `--mh` also runs phase 11b's default MH run and
prints its draws, R-1 and the sha256 of its chain files: two checkouts give
the same chains when the sha256 agree, on one software stack. `--backward`
times the backward kernel instead: the three lookups of one gradient of
phase 12's HMC target (sigma_v (1, 1200000) dq only; v_r and xi_0 (8,
150000) f64, per-point tables, dq and dcoeffs), with how their queries fall
into intervals, each checked against the plain version and timed device
only with L2 warm and cold (`chip_smoke.backward_cold_ms`) and for host us
per call; the same lookups in f32; K = 2 and 3 over (8, 150000); and the
device time of the HMC leapfrog under torch.profiler, the backward's share
of it. `--second-order` times the root's `ppoly_eval_second_order` instead
(the fused kernel on a tree that has one, the composed path before it): the
three lookups of one Hessian of phase 13's BOSS target (sigma_v (1,
600000), v_r and xi_0 (4, 150000), captured) in f64 and f32 and K = 2 and 3
over (8, 150000), device only with L2 warm and cold and for host us per
call; on a tree with the fused kernel also its composed path in turns, held
equal to it entry for entry; then the wall time, kernel time under
torch.profiler and second-order launches of three 4 x 4 Hessians. The last
line is one JSON object with every reading; `--out` writes it to a file as
well.

This is an A/B tool. To compare two versions on one card, unpack the older
commit into a git-ignored directory and time both in turns in one command:

    git archive <commit> | tar -x -C build/parent
    for r in build/parent . . build/parent; do
        python3 tools/ppoly_timing.py --root $r; done

(`--backward` or `--second-order` in the loop for the backward kernel or
the second order.)
"""

import argparse
import importlib.util
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def forward_rows(cs, gen, keep, rows):
    """The forward kernel: chip_smoke's ppoly_eval phases, the MH step's
    lookups with L2 cold and warm, and rows shorter than a tile."""
    import torch
    from victor_tpu_torch.io.tables import build_tables
    from victor_tpu_torch.kernels.ppoly import ppoly_eval_cuda

    f64 = torch.float64
    for key, result in cs.ppoly_phase(gen).items():
        dtype = key[0]
        if key[1] == 'multi':
            label = f'K={key[2]} {"shared" if key[3] else "per-row"} n=30'
        else:
            label = (f'n={key[1]} {"per-row" if key[2] else "shared"} '
                     f'clamp={key[3]}')
        keep(f'{label} {dtype}', result, getattr(torch, dtype))

    cfg = cs.load_config()
    bundle = build_tables(cfg['model'], cfg['data'], device='cuda',
                          dtype=f64)
    largest, step = cs.sampler_kernel_case(bundle, cs.draw_theta(8, 5, 'cuda'))
    for label, result in step.items():
        keep(label, result, f64)
    keep('MH step, largest, L2 cold (warm_ms: warm)', largest, f64)

    # rows shorter than a tile, as the Chebyshev-node lookups give them
    x = torch.linspace(0.01, 120.0, 31, device='cuda', dtype=f64)
    for B, M in ((8, 25), (8, 49), (64, 49)):
        coeffs = torch.randn((B, 30, 4), generator=gen, device='cuda',
                             dtype=f64)
        q = torch.rand((B, M), generator=gen, device='cuda', dtype=f64)
        q = q * 130.0 - 5.0

        def call():
            return ppoly_eval_cuda(x, coeffs, q)
        rows[f'small rows ({B}, {M}) n=31 per-row float64'] = {
            'ms': cs.device_ms(call, reps=200), 'host_us': cs.host_us(call)}


def backward_rows(cs, bundle, gen, keep, rows):
    """The backward kernel at the HMC path's lookups (f64 and f32), at K = 2
    and 3, with L2 cold and warm, and the HMC leapfrog under
    torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from victor_tpu_torch.sampling import hmc

    def one(label, x, c, q, g, clamp, want_dq, want_dc):
        result = cs.compare_backward(label, x, c, q, g, clamp, want_dq,
                                     want_dc, time_it=True)
        result['warm_ms'] = result['ms']
        result['ms'] = cs.backward_cold_ms(x, c, q, g, clamp, want_dq,
                                           want_dc)
        keep(f'{label} (ms: L2 cold)', result, q.dtype)
        print(f'  {label}: L2 cold {result["ms"]:.5f} ms, warm '
              f'{result["warm_ms"]:.5f} ms', flush=True)

    for x, c, q, g, clamp, want_dq, want_dc in cs.hmc_backward_calls(bundle):
        groups = cs.interval_groups(x, q, clamp)
        print(f'HMC lookup coeffs={tuple(c.shape)} q={tuple(q.shape)}: '
              f'queries by interval {groups}', flush=True)
        for dtype in (torch.float64, torch.float32):
            label = (f'backward, HMC lookup coeffs={tuple(c.shape)} '
                     f'q={tuple(q.shape)} dq={want_dq} dcoeffs={want_dc} '
                     f'{str(dtype)[6:]}')
            one(label, *(t.to(dtype) for t in (x, c, q, g)), clamp, want_dq,
                want_dc)
            rows[label + ' (ms: L2 cold)']['groups'] = groups
    for K in (2, 3):
        x, c, q = cs.edge_inputs(8, cs.N_POINTS, 30, K, False, 0,
                                 torch.float64, gen)
        one(f'backward, K={K} coeffs={tuple(c.shape)} q={tuple(q.shape)} '
            'float64', x, c, q, cs.grad_out_like(q, K, gen), True, True,
            True)

    # the HMC leapfrog (8 chains, exact modes) under torch.profiler: one
    # step after one of warm-up, per leapfrog
    space, logpost_y = cs.boss_logpost(bundle)
    calls = [0]

    def counted(y):
        calls[0] += 1
        return logpost_y(y)
    y0, hgen = cs.hmc_start(space)
    st = hmc.init_chains(counted, y0, hgen)
    st, _ = hmc.run_segment(counted, st, 0, 1, n_warmup=60)
    torch.cuda.synchronize()
    calls[0] = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        hmc.run_segment(counted, st, 1, 1, n_warmup=60)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    per = 1e-3 / calls[0]
    total = sum(e.device_time_total for e in events) * per
    bwd = sum(e.device_time_total for e in events if 'ppoly_bwd' in e.key) \
        * per
    memset = sum(e.device_time_total for e in events
                 if 'memset' in e.key.lower()) * per
    rows['HMC leapfrog under torch.profiler'] = {
        'leapfrogs': calls[0], 'device_ms': total, 'backward_ms': bwd,
        'backward_share': bwd / total, 'memset_ms': memset,
        'backward_kernels': sorted({e.key for e in events
                                    if 'ppoly_bwd' in e.key})}
    print(f'HMC leapfrog under torch.profiler ({calls[0]} leapfrogs): '
          f'device {total:.4f} ms, the backward kernel {bwd:.4f} ms '
          f'({100 * bwd / total:.1f}%), memsets {memset:.4f} ms per '
          'leapfrog', flush=True)


def second_order_rows(cs, bundle, gen, rows):
    """The root's second-order terms at a Hessian's lookups (f64, f32) and
    at K = 2 and 3 over (8, 150000) f64, L2 warm and cold and host us; on a
    root with the fused kernel its composed path too, in turns, held equal
    to it; then three Hessians' wall and kernel time."""
    import torch
    from victor_tpu_torch.kernels import ppoly

    composed = getattr(ppoly, 'ppoly_eval_second_order_composed', None)
    # the composed path's ~35 launches a call: 10 calls fit the launch queue
    fns = [('', ppoly.ppoly_eval_second_order, 10 if composed is None else 50)]
    if composed is not None:
        fns.append(('composed_', composed, 10))

    def one(label, x, c, q, g, u, V, clamp, wants):
        K = c.shape[1] if c.ndim == 4 else 1
        out = ppoly.ppoly_eval_second_order(x, c, q, g, u, V, clamp, *wants)
        row = {'bytes': cs.nbytes(*(a for a in (x, c, q, g, u, V, *out)
                                    if a is not None))}
        bound_ms, _ = cs.bound(row['bytes'], q.numel() * cs.second_order_ops(
            x.shape[0], K), q.dtype)
        if composed is not None:
            equal, bits = cs.same_terms(out, composed(x, c, q, g, u, V, clamp,
                                                      *wants))
            cs.check(equal, f'{label}: fused equals composed ({bits} '
                            'entries with other bits)')
            row['other_bits'] = bits
        calls = {p: (lambda fn=fn: fn(x, c, q, g, u, V, clamp, *wants))
                 for p, fn, _ in fns}
        reps = {p: r for p, _, r in fns}
        order = list(calls) + list(calls)[::-1]
        warm = {p: [] for p in calls}
        for p in order:                            # in turns
            warm[p].append(cs.device_ms(calls[p], reps[p]))
        for p, fn, r in fns:
            row[p + 'ms'] = sum(warm[p]) / 2
            row[p + 'cold_ms'] = cs.second_order_cold_ms(fn, r, x, c, q, g,
                                                         u, V, clamp, wants)
            row[p + 'host_us'] = cs.host_us(calls[p], calls=20 * r,
                                            chunk=2 * r)
        row.update(bound_ms=bound_ms, share=bound_ms / row['ms'],
                   cold_share=bound_ms / row['cold_ms'])
        rows[label] = row
        print(f'  {label}: ' + ', '.join(f'{k} {v:.5g}' for k, v in
                                          row.items()), flush=True)

    calls = cs.hessian_second_order_calls(bundle)
    for dtype in (torch.float64, torch.float32):
        for x, c, q, g, u, V, clamp, wants in calls:
            x, c, q, g, u, V = (None if a is None else a.to(dtype)
                                for a in (x, c, q, g, u, V))
            one(f'second order, Hessian lookup coeffs={tuple(c.shape)} '
                f'q={tuple(q.shape)} clamp={clamp} wants={wants} '
                f'{str(dtype)[6:]}', x, c, q, g, u, V, clamp, wants)
    for K in (2, 3):
        x, c, q = cs.edge_inputs(8, cs.N_POINTS, 30, K, False, 0,
                                 torch.float64, gen)
        u, V = cs.cotangents(c, q, gen)
        one(f'second order, K={K} coeffs={tuple(c.shape)} q={tuple(q.shape)}'
            ' float64', x, c, q, cs.grad_out_like(q, K, gen), u, V, True,
            (True, True, True))
    for i in range(3):
        t = cs.hessian_timing(bundle)
        rows[f'4 x 4 Hessian {i + 1}'] = t
        print(f'  4 x 4 Hessian {i + 1}: {t}', flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--root', default=REPO,
                        help='checkout whose victor_tpu_torch is timed')
    parser.add_argument('--mh', action='store_true',
                        help="also run phase 11b's default MH run")
    parser.add_argument('--backward', action='store_true',
                        help='time the backward kernel at the HMC path\'s '
                             'lookups instead')
    parser.add_argument('--second-order', action='store_true',
                        help="time the second-order terms at a Hessian's "
                             'lookups instead')
    parser.add_argument('--out', help='also write the JSON line here')
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    # this repository's chip_smoke.py, whatever the root holds
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(REPO, 'chip_smoke.py'))
    cs = importlib.util.module_from_spec(spec)
    sys.modules['chip_smoke'] = cs
    spec.loader.exec_module(cs)
    import torch
    if not torch.cuda.is_available():
        print('ppoly_timing: no CUDA device', file=sys.stderr)
        return 1
    import victor_tpu_torch
    from victor_tpu_torch.io.tables import build_tables
    from victor_tpu_torch.kernels import _build
    if not victor_tpu_torch.__file__.startswith(root):
        raise RuntimeError(f'imported {victor_tpu_torch.__file__}, not the '
                           f'package under {root}')
    card = cs.card_line()
    print(f'root {root}; card: {card}', flush=True)
    lib = _build.build('ppoly_eval')
    print(lib.with_suffix('.log').read_text().strip(), flush=True)

    f64 = torch.float64
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    rows = {}

    def keep(label, result, dtype):
        bound_ms, _ = cs.bound(result['bytes'], result['ops'], dtype)
        rows[label] = {k: result[k] for k in ('ms', 'plain_ms', 'host_us')}
        rows[label].update(bound_ms=bound_ms,
                           share=bound_ms / result['ms'])
        if 'warm_ms' in result:
            rows[label]['warm_ms'] = result['warm_ms']

    if args.backward or args.second_order:
        cfg = cs.load_config()
        bundle = build_tables(cfg['model'], cfg['data'], device='cuda',
                              dtype=f64)
        if args.backward:
            backward_rows(cs, bundle, gen, keep, rows)
        else:
            second_order_rows(cs, bundle, gen, rows)
    else:
        forward_rows(cs, gen, keep, rows)
    summary = {'root': root, 'card': card, 'kernels': rows}
    if args.mh:
        import tempfile
        with tempfile.TemporaryDirectory() as tmp:
            _, steps, _, n_draws, rm1, digest = cs.mh_posterior(
                cs.load_config(), tmp)
        summary['mh'] = {'steps': steps, 'draws': n_draws, 'rm1': rm1,
                         'sha256': digest}
    line = json.dumps(summary)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as f:
            f.write(line + '\n')
    print(line, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
