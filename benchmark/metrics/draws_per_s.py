"""draws_per_s: HMC chain-steps completed in the window, summed over the
chains, over the window's seconds (host clock)."""


def read(run):
    return run.units / run.window_s
