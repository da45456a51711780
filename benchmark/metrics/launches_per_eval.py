"""launches_per_eval: kernels launched on the card(s) in the traced
window, per likelihood evaluation. Read as launches_per_eval.smc and
launches_per_eval.mesh."""


def read(run):
    if run.trace is None or not run.trace.kernels or not run.evals:
        return None
    return run.trace.kernels / run.evals
