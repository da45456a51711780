"""sampler_host_pct: the host's time in the sampler layer's own code, in
percent of the traced window: the self time of the program's `smc.*` and
`hmc.*` spans (each span's time less what its child spans cover:
`likelihood.*` and `mesh.*` are the layers below). The program times its
spans on the host's clock only while a profiler runs, which --trace 1
keeps on over the window alone, and sums them by name
(`victor_tpu_torch.utils.profiling.span_self_s`). Read as
sampler_host_pct.smc, sampler_host_pct.hmc and sampler_host_pct.mesh; a
program without spans reads nothing."""

#: the first word of the sampler layer's spans
SAMPLER = ('smc.', 'hmc.')


def read(run):
    if run.trace is None:
        return None
    from victor_tpu_torch.utils import profiling
    self_s = getattr(profiling, 'span_self_s', None)
    if self_s is None:
        return None
    own = [s for name, s in self_s().items() if name.startswith(SAMPLER)]
    if not own:
        return None
    return 100.0 * sum(own) / run.trace.window_s
