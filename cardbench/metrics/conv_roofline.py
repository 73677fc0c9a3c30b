"""The dense trunk convs (c1, c2 and the downsample: the work module's
kind ``conv``), percent of their roofline: the sum of each launch's bound
over the device time under those layers' scopes."""

from cardbench.context import roofline_share


def read(ctx):
    return roofline_share(ctx, "conv")
