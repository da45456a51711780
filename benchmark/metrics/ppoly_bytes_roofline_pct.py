"""ppoly_bytes_roofline_pct: the spline lookups' share of their roofline,
their bytes counted by the program at each launch.

The work is `ppoly.bytes` summed over the cards
(`victor_tpu_torch.utils.profiling.total`: each input tensor of a
`ppoly_*` launch read once and each output written once, from the tensors
actually passed). The program counts bytes only while a profiler runs,
which --trace 1 keeps on over the window alone, so the count is the
window's. Over 3.35 TB/s that is the least time the card could take;
divided by the summed trace time of the `ppoly_*` kernels, in percent.
Without the counter, or with no such kernel in the trace, it reads
nothing. Read as ppoly_bytes_roofline_pct.hmc."""

from benchlib.roofline import HBM_BYTES_PER_S

MARK = 'ppoly_'


def read(run):
    if run.trace is None:
        return None
    from victor_tpu_torch.utils import profiling
    if not hasattr(profiling, 'count_bytes'):
        return None
    work = profiling.total('ppoly.bytes')
    seconds = sum(s for n, s in run.trace.kernel_s_by_name.items()
                  if MARK in n)
    if work <= 0 or seconds <= 0:
        return None
    return 100.0 * work / HBM_BYTES_PER_S / seconds
