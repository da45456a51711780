"""device_us_per_eval: microseconds in which a device operation ran (the
union of kernels, copies and fills in the trace), summed over the cards the
cell uses, per likelihood evaluation of the window. Read as
device_us_per_eval.smc (one card) and device_us_per_eval.mesh (four)."""


def read(run):
    if run.trace is None or not run.trace.kernels or not run.evals:
        return None
    return sum(run.trace.busy_s.values()) / run.evals * 1e6
