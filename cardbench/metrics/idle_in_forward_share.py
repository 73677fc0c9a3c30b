"""Share of the host slice's window in which the card ran nothing while
the host was inside a layer's scope (the work module's layers: ``stem``,
``b{i}.c1`` ... ``pool``, ``fc``), issuing the forward, percent: the card
waiting on the host's launches."""

from cardbench import spans


def read(ctx):
    return spans.idle_share_in(ctx, sorted({l.scope for l in ctx.layers}))
