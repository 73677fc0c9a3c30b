"""Share of the window's untraced calls in which the card idled, percent,
estimated from the run's own numbers: 1 - (device busy time a batch in
the device slice x the untraced calls' batches) / their host-clock
seconds.  The profiler costs the host time a launch, and the host paces
the cells, so ``device_idle_share`` reads higher than the calls that no
profiler slows; this stands beside it."""


def read(ctx):
    if not ctx.intervals or ctx.untraced_s <= 0:
        return None
    busy = ctx.busy_s / ctx.batches * ctx.untraced_batches
    return 100.0 * (1.0 - busy / ctx.untraced_s)
