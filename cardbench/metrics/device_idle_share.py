"""Share of the device slice (its host-clock length) in which no kernel,
copy or fill ran on the device, percent.  The slice records device
activity alone, so the profiler adds little to the host's time a
launch."""


def read(ctx):
    if not ctx.intervals:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
