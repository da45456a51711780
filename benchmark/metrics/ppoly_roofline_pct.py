"""ppoly_roofline_pct: the spline lookups' share of their roofline.

The work is the bytes the window's lookups need (`roofline.lookup_bytes`:
each input read once and each output written once, forward and backward)
for the lookups the configuration lists, per batched evaluation of the
chains, times the evaluations with gradient the sampler ran (counted at
the likelihood's entry, from the trajectories, not from launches). Over
3.35 TB/s that is the least time the card could take; divided by the
summed device time of the kernels named below, in percent. With no such
kernel in the trace it reads nothing. Read as ppoly_roofline_pct.hmc."""

from benchlib.roofline import HBM_BYTES_PER_S, evaluation_bytes

KERNELS = ('ppoly_tiles', 'ppoly_bwd_chunks', 'ppoly_bwd_reduce')


def read(run):
    if run.trace is None or not run.grad_evals:
        return None
    seconds = sum(s for n, s in run.trace.kernel_s_by_name.items()
                  if any(k in n for k in KERNELS))
    if seconds <= 0:
        return None
    rows = int(run.cell.traffic['n_chains'])
    calls = run.grad_evals / rows
    work = evaluation_bytes(run.cell.config['lookups'], rows, run.itemsize,
                            gradient=True) * calls
    return 100.0 * work / HBM_BYTES_PER_S / seconds
