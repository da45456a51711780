"""launches_per_draw: kernels launched on the card in the traced window,
per chain-step. Read as launches_per_draw.hmc."""


def read(run):
    if run.trace is None or not run.trace.kernels or not run.units:
        return None
    return run.trace.kernels / run.units
