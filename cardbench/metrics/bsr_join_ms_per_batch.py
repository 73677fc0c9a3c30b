"""Device time of the residual joins after the block-sparse layers that
have one (``join``: ``add_residual`` and the copy to channels-last), over
the host slice's batches, milliseconds."""

from cardbench import spans


def read(ctx):
    return spans.device_ms_per_batch_under(ctx, "join")
