"""The bottlenecks' 1x1 expand convs with their residual joins (c3: the
work module's kind ``expand``), percent of their roofline: the sum of
each launch's bound over the device time under those layers' scopes."""

from cardbench.context import roofline_share


def read(ctx):
    return roofline_share(ctx, "expand")
