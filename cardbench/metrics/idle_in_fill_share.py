"""Share of the host slice's window in which the card ran nothing while
the host was filling the staging ring (``engine.fill``), percent.  With
``idle_in_drain_share`` and ``idle_in_forward_share`` it splits the
slice's idle by what the host was doing; the three sum to at most the
slice's idle share."""

from cardbench import spans


def read(ctx):
    return spans.idle_share_in(ctx, ["engine.fill"])
