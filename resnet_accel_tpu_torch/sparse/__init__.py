"""Block-sparse (BSR) weight matrices, their exact regrouping to larger
blocks, tap-aligned block-sparse conv weights and the BSR artifact files,
in numpy."""

from resnet_accel_tpu_torch.sparse.bsr import (
    REF_BLOCK,
    BSRMatrix,
    build_bsr,
    build_bsr_int8_direct,
    conv_weight_to_2d,
    round_up,
)
from resnet_accel_tpu_torch.sparse.conv_bsr import (
    ConvBSR,
    PackedConvBSR,
    device_pack,
    pack_conv_bsr,
    tap_sparse_weight,
)
from resnet_accel_tpu_torch.sparse.io import (
    bsr_metadata,
    deserialize_hw_stream,
    load_layer_dir,
    load_layer_scales_bias,
    pack_dma_image,
    save_layer_dir,
    serialize_hw_stream,
    unpack_dma_image,
)
from resnet_accel_tpu_torch.sparse.regroup import (
    MXU_BLOCK,
    effective_density,
    regroup_bsr,
)

__all__ = ["MXU_BLOCK", "REF_BLOCK", "BSRMatrix", "ConvBSR",
           "PackedConvBSR", "bsr_metadata", "build_bsr",
           "build_bsr_int8_direct", "conv_weight_to_2d",
           "deserialize_hw_stream", "device_pack", "effective_density",
           "load_layer_dir", "load_layer_scales_bias", "pack_conv_bsr",
           "pack_dma_image", "regroup_bsr", "round_up", "save_layer_dir",
           "serialize_hw_stream", "tap_sparse_weight", "unpack_dma_image"]
