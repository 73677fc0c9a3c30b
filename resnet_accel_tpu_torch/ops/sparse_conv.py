"""Zero-skip int8 convolution without im2col: kernel K8 and its plain
version.

Counterpart of ``resnet_accel_tpu/ops/sparse_conv.py``
(``sparse_conv2d_int8``).  The weights are tap-aligned BSR blocks
(:mod:`resnet_accel_tpu_torch.sparse.conv_bsr`, uploaded by
``device_pack``); only stored blocks are visited, and each block's
activations are the strided window of the padded input at its tap, so no
patch matrix is ever built.  Both versions compute, per output channel o,

    acc = sum over the stored blocks of window(x, kh, kw, cb) @ block
    acc = acc + bias[o]; acc = relu(acc)           if given
    out = clip(rint(float32(acc) * factors[o]))    if factors is given

and return [N, c_out, Ho, Wo] in channels-last memory order: int8 with
``factors``, int32 without.  ``sparse_conv2d_int8`` launches the CUDA
kernel ``csrc/sparse_conv.cu`` for CUDA tensors and runs
:func:`sparse_conv2d_int8_plain` for CPU tensors.

The kernel has two routes, chosen by block shape and alignment
(:func:`sparse_conv_plan`) and counted by ``_kernels.variant_counts()``:
``wgmma_tma``, the Hopper main loop (``csrc/sm90_gemm_s8.cuh``) walking
each output block's stored blocks as K4 walks a block row, over the conv
windows that K2 reads through a TMA map in im2col mode (the blocks'
``col`` gives their place in K2's (kh, kw, c) K order); ``mma_sync`` for
the blocks its tiles do not take (the reference's (16, 14)) and unaligned
bases.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from resnet_accel_tpu_torch import _kernels
from resnet_accel_tpu_torch._kernels import GemmPlan
from resnet_accel_tpu_torch.ops.epilogue import requantize
from resnet_accel_tpu_torch.sparse.conv_bsr import PackedConvBSR


def _out_hw(x: torch.Tensor, packed: PackedConvBSR, stride: int):
    N, C, H, W = x.shape
    if C != packed.c_in:
        raise ValueError(f"input C={C}, weights expect {packed.c_in}")
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    k, p = packed.kernel, packed.padding
    return (H + 2 * p - k) // stride + 1, (W + 2 * p - k) // stride + 1


def sparse_conv2d_int8_plain(
    x: torch.Tensor,
    packed: PackedConvBSR,
    *,
    bias: Optional[torch.Tensor] = None,
    factors: Optional[torch.Tensor] = None,
    relu: bool = False,
    stride: int = 1,
) -> torch.Tensor:
    """Plain PyTorch version: walk the stored blocks, take each block's
    strided window of the padded input (channels last), contract it with
    the block and add it into the block's output channels.  In float64,
    which is exact (see ``matmul_int8_plain``)."""
    N = x.shape[0]
    Ho, Wo = _out_hw(x, packed, stride)
    p, s = packed.padding, stride
    bc, bo = packed.block_c, packed.block_o
    xh = F.pad(x, (p,) * 4).permute(0, 2, 3, 1).to(torch.float64)
    acc = torch.zeros((N * Ho * Wo, packed.n_ob * bo), dtype=torch.float64,
                      device=x.device)
    ob_of = torch.repeat_interleave(torch.arange(packed.n_ob),
                                    packed.o_ptr.diff().cpu())
    taps = zip(ob_of.tolist(), packed.kh.tolist(), packed.kw.tolist(),
               packed.cb.tolist())
    blocks = packed.blocks.to(torch.float64)
    for i, (ob, kh, kw, cb) in enumerate(taps):
        win = xh[:, kh:kh + s * (Ho - 1) + 1:s, kw:kw + s * (Wo - 1) + 1:s,
                 cb * bc:(cb + 1) * bc]
        acc[:, ob * bo:(ob + 1) * bo] += win.reshape(-1, bc) @ blocks[i].t()
    acc = acc[:, :packed.c_out].to(torch.int32)
    if factors is not None:
        out = requantize(acc, factors, relu=relu, bias=bias)
    else:
        if bias is not None:
            acc = acc + bias.to(torch.int32)
        out = acc.clamp_min(0) if relu else acc
    # [N*Ho*Wo, O] is NHWC: as NCHW it is channels-last already
    return out.view(N, Ho, Wo, -1).permute(0, 3, 1, 2)


def sparse_conv_plan(x: torch.Tensor, packed: PackedConvBSR) -> GemmPlan:
    """K8's route for ``x`` against ``packed``, from shapes and pointers.

    ``wgmma_tma``, the Hopper main loop, where its tiles take the blocks
    and TMA the bases: ``block_c % 32 == 0`` (a K stage is 128, 64 or 32
    of a block's channels, so C % 32 == 0 too), ``block_o % 8 == 0`` (each
    tile's columns start on 8 bytes), x and the blocks 16-byte aligned.
    Its N tile is 64 channels of one output block, ``ceil(block_o / 64)``
    tiles a block each walking the block's whole list: on the H100 two
    64-wide tiles a 128-wide block beat one 128-wide tile at three cases
    of the conv sweep and tied at the fourth (``kernel_ab.py --cases K8``;
    PERF.md §6).  No split along K.  Any other block or base:
    ``mma_sync``, whose tiles take any block."""
    if (packed.block_c % 32 == 0 and packed.block_o % 8 == 0
            and x.data_ptr() % 16 == 0
            and packed.blocks.data_ptr() % 16 == 0):
        return GemmPlan("wgmma_tma", 64, 1)
    return GemmPlan("mma_sync", 0, 1)


#: The C launcher's route codes, by variant.
_PATHS = {"mma_sync": 0, "wgmma_tma": 1}


def sparse_conv2d_int8(
    x: torch.Tensor,
    packed: PackedConvBSR,
    *,
    bias: Optional[torch.Tensor] = None,
    factors: Optional[torch.Tensor] = None,
    relu: bool = False,
    stride: int = 1,
) -> torch.Tensor:
    """Zero-skip conv: ``x`` [N, C, H, W] int8 (channels-last on a card),
    ``packed`` from ``device_pack``, optional ``bias`` [c_out] int32 and
    ``factors`` [c_out] float32 -> [N, c_out, Ho, Wo], int8 with
    ``factors`` and int32 without.  Any block shape the packer takes; the
    kernel's route is :func:`sparse_conv_plan`'s."""
    if x.device.type == "cpu":
        return sparse_conv2d_int8_plain(x, packed, bias=bias, factors=factors,
                                        relu=relu, stride=stride)
    if x.device.type != "cuda":
        raise ValueError(f"sparse_conv2d_int8: unsupported device {x.device}")
    Ho, Wo = _out_hw(x, packed, stride)
    bc, bo = packed.block_c, packed.block_o
    N, C, H, W = x.shape
    O, nnz, dev = packed.c_out, packed.nnz_source, x.device
    _kernels.check(x, "x", torch.int8, (N, C, H, W), dev, torch.channels_last)
    _kernels.check(packed.blocks, "blocks", torch.int8, (nnz, bo, bc), dev)
    _kernels.check(packed.o_ptr, "o_ptr", torch.int32, (packed.n_ob + 1,),
                   dev)
    for name in ("kh", "kw", "cb", "col"):
        _kernels.check(getattr(packed, name), name, torch.int32, (nnz,), dev)
    if bias is not None:
        _kernels.check(bias, "bias", torch.int32, (O,), dev)
    if factors is not None:
        _kernels.check(factors, "factors", torch.float32, (O,), dev)
    out = torch.empty((N, O, Ho, Wo), device=dev,
                      dtype=torch.int8 if factors is not None
                      else torch.int32, memory_format=torch.channels_last)
    plan = sparse_conv_plan(x, packed)
    _kernels.launch(
        "sparse_conv", dev, x.data_ptr(), packed.blocks.data_ptr(),
        packed.o_ptr.data_ptr(), packed.kh.data_ptr(), packed.kw.data_ptr(),
        packed.cb.data_ptr(), packed.col.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if factors is None else factors.data_ptr(), out.data_ptr(),
        N, H, W, C, Ho, Wo, packed.kernel, stride, packed.padding, O, bc, bo,
        packed.n_ob, nnz, int(relu), _PATHS[plan.variant], plan.bn,
        variant=plan.variant)
    return out
