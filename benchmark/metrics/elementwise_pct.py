"""elementwise_pct: the share of the window's kernel time spent in
PyTorch's elementwise kernels (`elementwise_kernel` in the name: the
unfused Clenshaw passes of the fast streaming mode, and every other
elementwise operator), in percent of all kernel time. Read as
elementwise_pct.smc."""

MARK = 'elementwise_kernel'


def read(run):
    if run.trace is None or not run.trace.kernels:
        return None
    part = sum(s for n, s in run.trace.kernel_s_by_name.items() if MARK in n)
    return 100.0 * part / run.trace.kernel_s
