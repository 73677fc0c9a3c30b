"""The compute path: the kernel wrappers (K1-K8 and K10) with their plain
versions, the int8 epilogues, pools and layout ops they share, and the
gather-compact BSR product of the LM's projections."""

from resnet_accel_tpu_torch.ops.bsr_matmul import (
    GatherBSR,
    PackedBSR,
    bsr_matmul_wt,
    bsr_matmul_wt_plain,
    bsr_matmul_wt_xla,
    bsr_plan,
    device_pack_gather,
    pack_bsr,
    pack_gather_bsr,
)
from resnet_accel_tpu_torch.ops.conv import (
    conv2d_int8,
    conv2d_int8_plain,
    im2col_nchw,
    pack_weight,
    space_to_depth_nchw,
    stem_s2d_weights,
)
from resnet_accel_tpu_torch.ops.epilogue import (
    add_residual,
    exact_inv_out_scale,
    exact_pow2_inv,
    quantize_input,
    requant_factors,
    requantize,
    requantize_q16,
)
from resnet_accel_tpu_torch.ops.expand_fused import (
    expand_add_int8,
    expand_add_int8_plain,
    expand_plan,
)
from resnet_accel_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_plain,
)
from resnet_accel_tpu_torch.ops.fused_stem import (
    fused_stem_pool,
    stem_conv_pool_int8,
    stem_conv_pool_int8_plain,
)
from resnet_accel_tpu_torch.ops.matmul_int8 import (
    matmul_int8,
    matmul_int8_plain,
    matmul_plan,
)
from resnet_accel_tpu_torch.ops.pooling import (
    avgpool_global_int8,
    maxpool2d_int8,
)
from resnet_accel_tpu_torch.ops.sparse_conv import (
    sparse_conv2d_int8,
    sparse_conv2d_int8_plain,
    sparse_conv_plan,
)
from resnet_accel_tpu_torch.ops.stem_pack import (
    quantize_s2d,
    quantize_s2d_nchw,
    quantize_s2d_wh,
    transpose_taps,
)
from resnet_accel_tpu_torch.ops.stem_fused import (
    pack_stem_weight,
    stem_conv_pool,
    stem_conv_pool_plain,
    stem_plan,
)

__all__ = [
    "GatherBSR",
    "PackedBSR",
    "add_residual",
    "avgpool_global_int8",
    "bsr_matmul_wt",
    "bsr_matmul_wt_plain",
    "bsr_matmul_wt_xla",
    "bsr_plan",
    "conv2d_int8",
    "conv2d_int8_plain",
    "device_pack_gather",
    "exact_inv_out_scale",
    "exact_pow2_inv",
    "expand_add_int8",
    "expand_add_int8_plain",
    "expand_plan",
    "flash_attention",
    "flash_attention_plain",
    "fused_stem_pool",
    "im2col_nchw",
    "matmul_int8",
    "matmul_int8_plain",
    "matmul_plan",
    "maxpool2d_int8",
    "pack_bsr",
    "pack_gather_bsr",
    "pack_stem_weight",
    "pack_weight",
    "quantize_input",
    "quantize_s2d",
    "quantize_s2d_nchw",
    "quantize_s2d_wh",
    "requant_factors",
    "requantize",
    "requantize_q16",
    "space_to_depth_nchw",
    "sparse_conv2d_int8",
    "sparse_conv2d_int8_plain",
    "sparse_conv_plan",
    "stem_conv_pool",
    "stem_conv_pool_int8",
    "stem_conv_pool_int8_plain",
    "stem_conv_pool_plain",
    "stem_plan",
    "stem_s2d_weights",
    "transpose_taps",
]
