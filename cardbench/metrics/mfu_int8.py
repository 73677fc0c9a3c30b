"""Useful int8 operations of the batches served in the device slice, per
second of the slice (host clock), as a percentage of the card's int8
peak.  Useful operations are the work module's count: dense layers at
their shapes, block-sparse ones over their stored blocks."""

from cardbench import peaks


def read(ctx):
    if not ctx.intervals:
        return None
    ops = ctx.batches * sum(l.ops for l in ctx.layers)
    return 100.0 * ops / ctx.window_s / peaks.INT8_OPS_PER_S
