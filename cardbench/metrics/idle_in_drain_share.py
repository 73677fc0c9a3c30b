"""Share of the host slice's window in which the card ran nothing while
the host ended a ``stream`` call (``engine.drain``: the last event's wait,
the logits' concatenation and copy to the host, argmax), percent."""

from cardbench import spans


def read(ctx):
    return spans.idle_share_in(ctx, ["engine.drain"])
