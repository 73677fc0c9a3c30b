"""Kernel launches a batch of the host slice: the CUDA runtime's and
driver's own records of a launch (``cudaLaunchKernel``,
``cuLaunchKernelEx`` ...) on the slice's thread inside its scope, a
driver record nested in a runtime one counted once, over the slice's
batches.  Every launch counts, the program's hand-written kernels and
PyTorch's own alike."""

from cardbench import spans, trace


def read(ctx):
    t0, t1, thread = spans.window(ctx)
    n, end = 0, float("-inf")
    for e in sorted((e for e in trace.complete(ctx.host_events,
                                               trace.LAUNCH_CATS)
                     if "Launch" in e["name"]
                     and (e["pid"], e["tid"]) == thread
                     and t0 <= float(e["ts"]) <= t1),
                    key=lambda e: float(e["ts"])):
        if float(e["ts"]) >= end:
            n += 1
            end = float(e["ts"]) + float(e["dur"])
    if n == 0:
        return None
    return n / ctx.host_batches
