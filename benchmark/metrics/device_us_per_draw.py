"""device_us_per_draw: microseconds in which a device operation ran on
the card (the union of kernels, copies and fills in the trace), per chain-
step of the window. Read as device_us_per_draw.hmc."""


def read(run):
    if run.trace is None or not run.trace.kernels or not run.units:
        return None
    return sum(run.trace.busy_s.values()) / run.units * 1e6
