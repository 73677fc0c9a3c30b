"""The block-sparse convs, percent of their roofline: the sum of each
layer's bound over its stored blocks, over all the device time under
those layers' scopes (im2col, the block-sparse product, the join)."""

from cardbench.context import roofline_share


def read(ctx):
    return roofline_share(ctx, "bsr")
