"""Device time of the block-sparse layers' im2col (``im2col``: the
patches' copies), over the host slice's batches, milliseconds."""

from cardbench import spans


def read(ctx):
    return spans.device_ms_per_batch_under(ctx, "im2col")
