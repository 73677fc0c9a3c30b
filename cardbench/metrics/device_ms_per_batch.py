"""Time in which an operation ran on the device in the device slice, per
batch served there, milliseconds: the card's own work a batch, which the
host's pace does not move."""


def read(ctx):
    if not ctx.intervals:
        return None
    return 1e3 * ctx.busy_s / ctx.batches
