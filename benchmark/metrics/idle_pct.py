"""idle_pct: the share of the traced window in which no device operation
ran on the card, in percent (the mean over the cards). Read as
idle_pct.smc and idle_pct.hmc."""


def read(run):
    if run.trace is None or not run.trace.kernels:
        return None
    busy = sum(run.trace.busy_s.values()) / len(run.trace.busy_s)
    return 100.0 * (1.0 - busy / run.trace.window_s)
