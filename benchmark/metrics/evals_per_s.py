"""evals_per_s: likelihood evaluations the SMC sampler completed in the window
(particles x moves per stage, plus each run's initial evaluation) over the
window's seconds (host clock). Read as evals_per_s (one card) and
evals_per_s.mesh (four cards), whose spreads and bounds are their own."""


def read(run):
    return run.units / run.window_s
