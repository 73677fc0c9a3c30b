"""Operations and bytes of each layer of an INT8 ResNet, per batch.

The yardstick for the roofline and MFU readers: what the layer's inputs
need, whatever implements it.  Each input byte is read once, each output
byte written once, and the weights, biases and requant factors once a
batch.  A convolution is 2 operations a multiply-accumulate over its
weight's elements; a block-sparse one over the elements its stored
blocks cover (edge blocks cut to the matrix), and its weight bytes are
the stored blocks whole, with an int32 column index each and an int32
row pointer a block row (plus one).  The scope of each row is the one the
program's model opens for the layer (``stem``, ``b{i}.c1`` ... ``fc``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from cardbench.reference.resnet_int8 import expansion, stem_conv, trunk


@dataclasses.dataclass(frozen=True)
class Layer:
    scope: str
    kind: str        # stem, conv, expand, bsr, pool, fc
    macs: int        # multiply-accumulates a batch
    bytes: int       # device-memory bytes a batch

    @property
    def ops(self) -> int:
        return 2 * self.macs


def layers(config, batch: int,
           stored: Optional[Dict[str, Dict[str, int]]] = None
           ) -> List[Layer]:
    """The network's layers at ``batch`` images.  ``stored`` gives each
    block-sparse conv's stored blocks (``reference.stored_blocks``); a
    conv absent from it is dense."""
    stored = stored or {}
    sp = config.get("sparsity") or {}
    bh, bw = sp.get("block", (0, 0))
    hw = config["image_size"]
    out: List[Layer] = []

    st = stem_conv(config)
    conv_hw = (hw + 2 * st.padding - st.kernel) // st.stride + 1
    pool_hw = (conv_hw + 2 - 3) // 2 + 1
    out.append(Layer(
        "stem", "stem",
        batch * conv_hw * conv_hw * st.out_c * st.in_c * st.kernel ** 2,
        batch * st.in_c * hw * hw + st.out_c * st.in_c * st.kernel ** 2
        + 8 * st.out_c + batch * st.out_c * pool_hw * pool_hw))

    h = pool_hw
    for convs in trunk(config):
        h_in = h
        for c in convs:
            hi = h_in if c.scope.endswith((".c1", ".ds")) else h
            ho = (hi + 2 * c.padding - c.kernel) // c.stride + 1
            joined = c.scope.endswith(".c3") or (
                c.scope.endswith(".c2") and not any(
                    x.scope.endswith(".c3") for x in convs))
            act = batch * (c.in_c * hi * hi + c.out_c * ho * ho
                           * (2 if joined else 1))
            k = c.in_c * c.kernel ** 2
            if c.scope in stored:
                s = stored[c.scope]
                out.append(Layer(
                    c.scope, "bsr", batch * ho * ho * s["elements"],
                    act + s["blocks"] * (bh * bw + 4)
                    + 4 * (s["block_rows"] + 1) + 8 * c.out_c))
            else:
                out.append(Layer(
                    c.scope, "expand" if c.scope.endswith(".c3") else "conv",
                    batch * ho * ho * c.out_c * k,
                    act + c.out_c * k + 8 * c.out_c))
            if not c.scope.endswith(".ds"):
                h = ho
    feat = config["widths"][-1] * expansion(config)
    out.append(Layer("pool", "pool", 0, batch * feat * (h * h + 1)))
    n_cls = config["num_classes"]
    out.append(Layer("fc", "fc", batch * feat * n_cls,
                     batch * feat + feat * n_cls + 8 * n_cls
                     + 4 * batch * n_cls))
    return out


def step_layers(config, traffic, ref) -> List[Layer]:
    """The layers of one batch of ``traffic``, the block-sparse ones over
    the blocks the reference ``ref`` stores."""
    return layers(config, traffic["batch"], ref.stored())


def bound_s(layer: Layer, peak_ops: float, peak_bytes: float) -> float:
    """The least time the layer could take on a chip with these peaks."""
    return max(layer.ops / peak_ops, layer.bytes / peak_bytes)
