"""Host time a batch in the engine's fill of its staging ring
(``engine.fill``), less the time it waited there for the card to release
a buffer (``engine.ring_wait``), over the host slice's batches,
milliseconds: the loader's ``next`` and the copy into the pinned
buffer."""

from cardbench import spans, trace


def read(ctx):
    fill = spans.spans(ctx, ["engine.fill"])
    if not fill:
        return None
    wait = spans.spans(ctx, ["engine.fill/engine.ring_wait"])
    us = trace.busy_us(fill) - trace.busy_us(wait)
    return 1e-3 * us / ctx.host_batches
