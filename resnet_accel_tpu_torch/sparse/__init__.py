"""Block-sparse (BSR) weight matrices, their exact regrouping to larger
blocks, and tap-aligned block-sparse conv weights, in numpy."""

from resnet_accel_tpu_torch.sparse.bsr import (
    REF_BLOCK,
    BSRMatrix,
    build_bsr,
    build_bsr_int8_direct,
    round_up,
)
from resnet_accel_tpu_torch.sparse.conv_bsr import (
    ConvBSR,
    PackedConvBSR,
    device_pack,
    pack_conv_bsr,
    tap_sparse_weight,
)
from resnet_accel_tpu_torch.sparse.regroup import (
    MXU_BLOCK,
    effective_density,
    regroup_bsr,
)

__all__ = ["MXU_BLOCK", "REF_BLOCK", "BSRMatrix", "ConvBSR",
           "PackedConvBSR", "build_bsr", "build_bsr_int8_direct",
           "device_pack", "effective_density", "pack_conv_bsr",
           "regroup_bsr", "round_up", "tap_sparse_weight"]
