"""Block-sparse (BSR) weight matrices, in numpy."""

from resnet_accel_tpu_torch.sparse.bsr import (
    REF_BLOCK,
    BSRMatrix,
    build_bsr,
    build_bsr_int8_direct,
    round_up,
)

__all__ = ["REF_BLOCK", "BSRMatrix", "build_bsr", "build_bsr_int8_direct",
           "round_up"]
