"""Device time of the block-sparse layers' product (``k4``: K4 with its
fused bias, ReLU and requant), over the host slice's batches,
milliseconds."""

from cardbench import spans


def read(ctx):
    return spans.device_ms_per_batch_under(ctx, "k4")
