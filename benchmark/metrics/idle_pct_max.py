"""idle_pct_max: the share of the traced window in which no device
operation ran on the idlest of the cards, in percent. Read as
idle_pct_max.mesh."""


def read(run):
    if run.trace is None or not run.trace.kernels:
        return None
    busy = min(run.trace.busy_s.values())
    return 100.0 * (1.0 - busy / run.trace.window_s)
