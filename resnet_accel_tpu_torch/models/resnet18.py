"""The INT8 ResNet family (ResNet-18/34/50/101/152) in PyTorch.

Counterpart of ``resnet_accel_tpu/models/resnet18.py``, which holds the
whole family: ``STAGE_PLANS`` gives each depth's stages; 18 and 34 use
basic blocks (``QBlock``), 50, 101 and 152 bottlenecks (``QBottleneck``:
1x1 reduce, 3x3 carrying the stride, 1x1 expand x4).
``models/resnet.py`` dispatches on depth.

- ``init_resnet18_fp32`` draws the same seeded fp32 parameters as the JAX
  package (a numpy copy, so both packages build identical weights);
- ``quantize_resnet18`` folds BatchNorm, quantizes weights per channel and
  calibrates activation scales with a float32 PyTorch forward on the CPU;
- ``ResNet18Int8`` holds the quantized model as numpy arrays, with
  ``.npz`` save and load, and ``from_reference`` carries the JAX package's
  quantized model across, so both packages compute with the same model;
- ``prune_params_blockwise`` zeroes whole weight blocks by magnitude and
  ``attach_bsr`` gives each layer with enough zero blocks its
  ``BSRMatrix`` (``QConv.bsr``): block-sparse serving;
- ``ResNet18Int8Module`` is the forward (fp32 or int8 NCHW images -> fp32
  logits), one route per layer:

      stem_conv_pool (K1), or stem_conv_pool_int8 (K10) for int8 images,
      or with ``stem_fused=False`` the space-to-depth stem:
        quantize_s2d (K6; for int8 images space_to_depth_nchw)
        -> conv2d_int8 (K2), 4x4/s1 padded ((2, 1), (2, 1)) on
           stem_s2d_weights -> maxpool2d_int8 3x3/s2/p1
      -> per block:
        basic:      conv2d_int8 (K2) for c1, for the downsample and for
                    c2 with the residual join fused in
        bottleneck: conv2d_int8 (K2) for c1, c2 and the downsample, then
                    expand_add_int8 (K7) for c3 with the residual join,
                    by the multiply by the block's proven reciprocal
                    (exact_inv_out_scale, found once at load) where the
                    proof holds, as the JAX make_forward joins
      -> avgpool_global_int8 -> matmul_int8 (K3) -> x fc_deq

  A trunk layer with BSR weights runs im2col_nchw -> bsr_matmul_wt (K4,
  the zero-block skip, with bias, ReLU and requant fused) instead of K2 or
  K7; a sparse c2 of a basic block or c3 of a bottleneck then joins its
  residual with ``add_residual``.  The stem always runs dense (the pruner
  never touches it).  Int8 images are taken as already quantized with
  ``s_input`` (the loader's work), as the JAX ``make_forward`` takes them;
  the CIFAR stem then only skips its quantize.

  On CUDA tensors every step above marked K runs its hand-written kernel;
  on CPU tensors the plain PyTorch versions run.  ``forward_plain`` runs
  the plain versions on any device, the reference the kernels are checked
  against on the card.  While a ``torch.profiler`` records, each layer
  runs in a ``record_function`` scope named after its row of
  ``runtime.profile.profile_resnet18`` (``stem``, ``b{i}.c1``,
  ``b{i}.c2`` with a basic block's join, ``b{i}.c3`` with a bottleneck's,
  ``b{i}.ds``, ``fc``) or ``pool``.

The numerical specification is the numpy golden ``forward_golden`` of the
JAX package's module.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from resnet_accel_tpu_torch.ops import (
    add_residual,
    avgpool_global_int8,
    bsr_matmul_wt,
    bsr_matmul_wt_plain,
    conv2d_int8,
    conv2d_int8_plain,
    exact_inv_out_scale,
    expand_add_int8,
    expand_add_int8_plain,
    im2col_nchw,
    matmul_int8,
    matmul_int8_plain,
    maxpool2d_int8,
    pack_bsr,
    pack_stem_weight,
    pack_weight,
    quantize_input,
    quantize_s2d,
    quantize_s2d_nchw,
    requant_factors,
    space_to_depth_nchw,
    stem_conv_pool,
    stem_conv_pool_int8,
    stem_conv_pool_int8_plain,
    stem_conv_pool_plain,
    stem_s2d_weights,
)
from resnet_accel_tpu_torch.quant import (bias_to_int32, pow2_scale,
                                          quantize_symmetric_per_channel)
from resnet_accel_tpu_torch.runtime.backend import resolve_device
from resnet_accel_tpu_torch.sparse.bsr import BSRMatrix, build_bsr_int8_direct

#: Stage plan: (out_channels, blocks, first_stride) of ResNet-18.
STAGES = [(64, 2, 1), (128, 2, 2), (256, 2, 2), (512, 2, 2)]
#: The family's plans (torchvision geometry); ``models/resnet.py``
#: dispatches on depth.
STAGE_PLANS = {
    18: STAGES,
    34: [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)],
    50: [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)],
    101: [(64, 3, 1), (128, 4, 2), (256, 23, 2), (512, 3, 2)],
    152: [(64, 3, 1), (128, 8, 2), (256, 36, 2), (512, 3, 2)],
}
BOTTLENECK_DEPTHS = frozenset({50, 101, 152})
EXPANSION = 4  # a bottleneck's output channels are out_c * EXPANSION
BN_EPS = 1e-5


# ==========================================================================
# FP32 parameters and BatchNorm folding
# ==========================================================================

def init_resnet18_fp32(
    seed: int = 0, num_classes: int = 1000, small_input: bool = False,
    stages=None, bottleneck: bool = False,
) -> Dict[str, np.ndarray]:
    """He-init fp32 parameters in torchvision's flat naming scheme, drawn
    from ``numpy.random.default_rng(seed)`` in the JAX package's order.
    ``stages`` and ``bottleneck`` give the family's other depths."""
    stages = STAGES if stages is None else stages
    rng = np.random.default_rng(seed)
    p: Dict[str, np.ndarray] = {}

    def conv(name, o, i, k):
        fan_in = i * k * k
        p[f"{name}.weight"] = (
            rng.normal(0, np.sqrt(2.0 / fan_in), (o, i, k, k))
        ).astype(np.float32)

    def bn(name, c):
        p[f"{name}.weight"] = np.ones(c, np.float32)
        p[f"{name}.bias"] = np.zeros(c, np.float32)
        p[f"{name}.running_mean"] = (
            rng.normal(0, 0.1, c).astype(np.float32))
        p[f"{name}.running_var"] = (
            rng.uniform(0.5, 1.5, c).astype(np.float32))

    conv("conv1", 64, 3, 3 if small_input else 7)
    bn("bn1", 64)
    in_c = 64
    for si, (out_c, blocks, stride) in enumerate(stages, start=1):
        exp_c = out_c * EXPANSION if bottleneck else out_c
        for b in range(blocks):
            base = f"layer{si}.{b}"
            c_in = in_c if b == 0 else exp_c
            if bottleneck:
                conv(f"{base}.conv1", out_c, c_in, 1)
                bn(f"{base}.bn1", out_c)
                conv(f"{base}.conv2", out_c, out_c, 3)
                bn(f"{base}.bn2", out_c)
                conv(f"{base}.conv3", exp_c, out_c, 1)
                bn(f"{base}.bn3", exp_c)
            else:
                conv(f"{base}.conv1", out_c, c_in, 3)
                bn(f"{base}.bn1", out_c)
                conv(f"{base}.conv2", out_c, out_c, 3)
                bn(f"{base}.bn2", out_c)
            if b == 0 and (stride != 1 or c_in != exp_c):
                conv(f"{base}.downsample.0", exp_c, c_in, 1)
                bn(f"{base}.downsample.1", exp_c)
        in_c = exp_c
    p["fc.weight"] = (
        rng.normal(0, 0.01, (num_classes, in_c)).astype(np.float32))
    p["fc.bias"] = np.zeros(num_classes, np.float32)
    return p


def fold_bn(
    conv_w: np.ndarray, bn_gamma, bn_beta, bn_mean, bn_var,
    eps: float = BN_EPS,
) -> Tuple[np.ndarray, np.ndarray]:
    """Fold inference-mode BatchNorm into the preceding conv:
    w' = w * gamma/sqrt(var+eps) per out channel, b' = beta - mean*that."""
    scale = bn_gamma / np.sqrt(bn_var + eps)
    w = conv_w * scale[:, None, None, None]
    b = bn_beta - bn_mean * scale
    return w.astype(np.float32), b.astype(np.float32)


def fold_all_bn(params_fp32: Dict[str, np.ndarray], stages=None,
                bottleneck: bool = False) -> Dict[str, np.ndarray]:
    """Fold every BatchNorm of a flat torchvision-style dict into its conv:
    {conv: w', conv + '.bias': b'}, plus the fc passthrough."""
    stages = STAGES if stages is None else stages
    folded: Dict[str, np.ndarray] = {}

    def fold(conv_name, bn_name):
        folded[conv_name], folded[conv_name + ".bias"] = fold_bn(
            params_fp32[f"{conv_name}.weight"],
            params_fp32[f"{bn_name}.weight"],
            params_fp32[f"{bn_name}.bias"],
            params_fp32[f"{bn_name}.running_mean"],
            params_fp32[f"{bn_name}.running_var"])

    fold("conv1", "bn1")
    for si, (_, blocks, _) in enumerate(stages, start=1):
        for b in range(blocks):
            base = f"layer{si}.{b}"
            fold(f"{base}.conv1", f"{base}.bn1")
            fold(f"{base}.conv2", f"{base}.bn2")
            if bottleneck:
                fold(f"{base}.conv3", f"{base}.bn3")
            if f"{base}.downsample.0.weight" in params_fp32:
                fold(f"{base}.downsample.0", f"{base}.downsample.1")
    folded["fc.weight"] = params_fp32["fc.weight"]
    folded["fc.bias"] = params_fp32["fc.bias"]
    return folded


# ==========================================================================
# Quantized model (numpy)
# ==========================================================================

@dataclasses.dataclass
class QConv:
    """One fused conv(-BN)(-ReLU)(-requant) layer."""

    w2d: np.ndarray          # [O, I*K*K] int8, flattened OIHW
    bias: np.ndarray         # [O] int32, accumulator domain
    factors: np.ndarray      # [O] float32 requant factors
    in_channels: int
    kernel: int
    stride: int
    padding: int
    relu: bool
    bsr: Optional[BSRMatrix] = None  # block-sparse w2d, from attach_bsr


@dataclasses.dataclass
class QBlock:
    conv1: QConv
    conv2: QConv
    downsample: Optional[QConv]
    s_in: float
    s_main: float
    s_res: float             # scale of the residual path (s_in or s_ds)
    s_out: float

    def named_convs(self, i: int):
        yield f"b{i}.c1", self.conv1
        yield f"b{i}.c2", self.conv2
        if self.downsample is not None:
            yield f"b{i}.ds", self.downsample


@dataclasses.dataclass
class QBottleneck:
    """Bottleneck block of ResNet-50/101/152: 1x1 reduce, 3x3 carrying
    the stride, 1x1 expand x4 without ReLU, then the residual join."""

    conv1: QConv             # 1x1 reduce, ReLU
    conv2: QConv             # 3x3 (carries the stride), ReLU
    conv3: QConv             # 1x1 expand, no ReLU (joined after)
    downsample: Optional[QConv]
    s_in: float
    s_main: float            # scale of the conv3 output
    s_res: float
    s_out: float

    def __post_init__(self):
        c3 = self.conv3
        if c3 is None or (c3.kernel, c3.stride, c3.padding, c3.relu) != (
                1, 1, 0, False):
            raise ValueError("a bottleneck's conv3 must be a 1x1 stride-1 "
                             "conv without ReLU")

    def named_convs(self, i: int):
        yield f"b{i}.c1", self.conv1
        yield f"b{i}.c2", self.conv2
        yield f"b{i}.c3", self.conv3
        if self.downsample is not None:
            yield f"b{i}.ds", self.downsample


_QCONV_ARRAYS = ("w2d", "bias", "factors")
_QCONV_INTS = ("in_channels", "kernel", "stride", "padding", "relu")
_QBLOCK_SCALES = ("s_in", "s_main", "s_res", "s_out")
_BSR_ARRAYS = ("data", "row_ptr", "col_idx")


@dataclasses.dataclass
class ResNet18Int8:
    stem: QConv
    blocks: List[Union[QBlock, QBottleneck]]
    fc_w: np.ndarray         # [num_classes, 512 or 2048] int8
    fc_b: np.ndarray         # [num_classes] int32
    fc_deq: np.ndarray       # [num_classes] float32 dequant of the fc acc
    s_input: float
    small_input: bool
    num_classes: int

    def named_convs(self):
        yield "stem", self.stem
        for i, blk in enumerate(self.blocks):
            yield from blk.named_convs(i)

    def sparsity_report(self) -> Dict[str, float]:
        """Block sparsity of each layer that carries BSR weights."""
        return {prefix: 1.0 - qc.bsr.nnz_blocks / qc.bsr.total_blocks
                for prefix, qc in self.named_convs() if qc.bsr is not None}

    def save_npz(self, path: str) -> None:
        arrays = {"fc_w": self.fc_w, "fc_b": self.fc_b,
                  "fc_deq": self.fc_deq,
                  "meta": np.array([self.s_input]),
                  "meta_int": np.array([int(self.small_input),
                                        self.num_classes,
                                        len(self.blocks)])}
        for prefix, qc in self.named_convs():
            for k in _QCONV_ARRAYS:
                arrays[f"{prefix}.{k}"] = getattr(qc, k)
            arrays[f"{prefix}.geom"] = np.array(
                [int(getattr(qc, k)) for k in _QCONV_INTS])
            if qc.bsr is not None:
                for k in _BSR_ARRAYS:
                    arrays[f"{prefix}.bsr.{k}"] = getattr(qc.bsr, k)
                arrays[f"{prefix}.bsr.geom"] = np.array(
                    [*qc.bsr.shape, qc.bsr.block_h, qc.bsr.block_w])
        for i, blk in enumerate(self.blocks):
            arrays[f"b{i}.scales"] = np.array(
                [getattr(blk, k) for k in _QBLOCK_SCALES], np.float64)
        np.savez(path, **arrays)

    @classmethod
    def load_npz(cls, path: str) -> "ResNet18Int8":
        with np.load(path, allow_pickle=False) as z:
            def qconv(prefix):
                geom = [int(v) for v in z[f"{prefix}.geom"]]
                bsr = None
                if f"{prefix}.bsr.geom" in z.files:
                    h, w, bh, bw = (int(v) for v in z[f"{prefix}.bsr.geom"])
                    bsr = BSRMatrix(**{k: z[f"{prefix}.bsr.{k}"]
                                       for k in _BSR_ARRAYS},
                                    shape=(h, w), block_h=bh, block_w=bw)
                return QConv(**{k: z[f"{prefix}.{k}"]
                                for k in _QCONV_ARRAYS},
                             **dict(zip(_QCONV_INTS[:-1], geom[:-1])),
                             relu=bool(geom[-1]), bsr=bsr)

            def block(i):
                convs = dict(conv1=qconv(f"b{i}.c1"), conv2=qconv(f"b{i}.c2"),
                             downsample=(qconv(f"b{i}.ds")
                                         if f"b{i}.ds.geom" in z.files
                                         else None))
                kind = QBlock
                if f"b{i}.c3.geom" in z.files:      # a bottleneck
                    kind, convs["conv3"] = QBottleneck, qconv(f"b{i}.c3")
                return kind(**convs, **{
                    k: float(v) for k, v in zip(_QBLOCK_SCALES,
                                                z[f"b{i}.scales"])})

            small_input, num_classes, n_blocks = (
                int(v) for v in z["meta_int"])
            blocks = [block(i) for i in range(n_blocks)]
            return cls(stem=qconv("stem"), blocks=blocks,
                       fc_w=z["fc_w"], fc_b=z["fc_b"], fc_deq=z["fc_deq"],
                       s_input=float(z["meta"][0]),
                       small_input=bool(small_input),
                       num_classes=num_classes)


def from_reference(model) -> ResNet18Int8:
    """Carry the JAX package's quantized ``ResNet18Int8`` across.

    Reads numpy attributes only (no import of the JAX module), so both
    packages compute with the very same quantized model.  A layer with the
    JAX package's packed BSR gets its ``BSRMatrix`` rebuilt from ``w2d`` at
    the same block shape, and must count the same stored and total
    blocks.  A block with a ``conv3`` is a bottleneck.
    """
    def qconv(qc) -> QConv:
        w2d = np.asarray(qc.w2d, np.int8)
        return QConv(w2d=w2d,
                     bias=np.asarray(qc.bias, np.int32),
                     factors=np.asarray(qc.factors, np.float32),
                     in_channels=int(qc.in_channels),
                     kernel=int(qc.kernel), stride=int(qc.stride),
                     padding=int(qc.padding), relu=bool(qc.relu),
                     bsr=bsr_from_reference(w2d, getattr(qc, "bsr", None)))

    blocks = []
    names = ("conv1", "conv2", "conv3", "downsample")
    for blk in model.blocks:
        convs = {k: getattr(blk, k) for k in names if hasattr(blk, k)}
        convs = {k: None if qc is None else qconv(qc)
                 for k, qc in convs.items()}
        kind = QBottleneck if "conv3" in convs else QBlock
        blocks.append(kind(
            **convs, s_in=float(blk.s_in), s_main=float(blk.s_main),
            s_res=float(blk.s_res), s_out=float(blk.s_out)))
    return ResNet18Int8(
        stem=qconv(model.stem), blocks=blocks,
        fc_w=np.asarray(model.fc_w, np.int8),
        fc_b=np.asarray(model.fc_b, np.int32),
        fc_deq=np.asarray(model.fc_deq, np.float32),
        s_input=float(model.s_input), small_input=bool(model.small_input),
        num_classes=int(model.num_classes))


def bsr_from_reference(w2d: np.ndarray, kbsr) -> Optional[BSRMatrix]:
    """The ``BSRMatrix`` of ``w2d`` at the block shape of the JAX package's
    ``KernelBSR`` ``kbsr`` (None for None); raise if the stored or total
    block counts differ from the JAX package's."""
    if kbsr is None:
        return None
    bsr = build_bsr_int8_direct(w2d, int(kbsr.block_h), int(kbsr.block_w))
    if (bsr.nnz_blocks, bsr.total_blocks) != (int(kbsr.nnz_source),
                                              int(kbsr.total_source)):
        raise ValueError(
            f"BSR rebuilt with {bsr.nnz_blocks}/{bsr.total_blocks} blocks, "
            f"the reference has {kbsr.nnz_source}/{kbsr.total_source}")
    return bsr


# ==========================================================================
# Quantization (PTQ with calibration)
# ==========================================================================

def _float_forward_taps(params: Dict[str, np.ndarray], x: torch.Tensor,
                        small_input: bool, stages=None,
                        bottleneck: bool = False):
    """Inference-mode fp32 forward (BN folded) returning activation taps,
    for calibration only."""
    stages = STAGES if stages is None else stages
    taps: Dict[str, torch.Tensor] = {}

    def conv(name, a, stride, padding):
        w = torch.from_numpy(params[name])
        b = torch.from_numpy(params[name + ".bias"])
        return F.conv2d(a, w, stride=stride, padding=padding) \
            + b[None, :, None, None]

    a = conv("conv1", x, 1, 1) if small_input else conv("conv1", x, 2, 3)
    a = a.clamp_min(0)
    taps["stem"] = a
    if not small_input:
        a = F.max_pool2d(a, 3, 2, padding=1)
    bi = 0
    for si, (_, blocks, stride) in enumerate(stages, start=1):
        for b in range(blocks):
            base = f"layer{si}.{b}"
            st = stride if b == 0 else 1
            if bottleneck:
                y = conv(f"{base}.conv1", a, 1, 0).clamp_min(0)
                taps[f"b{bi}.c1"] = y
                y = conv(f"{base}.conv2", y, st, 1).clamp_min(0)
                taps[f"b{bi}.c2"] = y
                y = conv(f"{base}.conv3", y, 1, 0)
                taps[f"b{bi}.c3"] = y
            else:
                y = conv(f"{base}.conv1", a, st, 1).clamp_min(0)
                taps[f"b{bi}.c1"] = y
                y = conv(f"{base}.conv2", y, 1, 1)
                taps[f"b{bi}.c2"] = y
            if f"{base}.downsample.0" in params:
                r = conv(f"{base}.downsample.0", a, st, 0)
                taps[f"b{bi}.ds"] = r
            else:
                r = a
            a = (y + r).clamp_min(0)
            taps[f"b{bi}.out"] = a
            bi += 1
    a = a.mean(dim=(2, 3))
    logits = a @ torch.from_numpy(params["fc.weight"]).t() \
        + torch.from_numpy(params["fc.bias"])
    taps["fc_in"] = a
    return logits, taps


def quantize_resnet18(
    params_fp32: Dict[str, np.ndarray],
    calib_x: np.ndarray,
    num_classes: int = 1000,
    small_input: bool = False,
    stages=None,
    bottleneck: bool = False,
    calib_batch_size: Optional[int] = None,
    calib_percentile: Optional[float] = None,
    pow2_input_scale: bool = False,
) -> ResNet18Int8:
    """Fold BN, quantize weights per channel to int8 and calibrate the
    activation scales over ``calib_x`` (fp32 NCHW), as the JAX package
    does.  Calibration runs on the CPU.

    ``calib_batch_size`` streams ``calib_x`` in chunks of that many images
    and keeps each tap's largest range over the chunks (None: one chunk).
    ``calib_percentile`` (e.g. 99.9) takes each chunk's |x| percentile as
    the range instead of the abs-max; outliers then saturate.
    ``pow2_input_scale`` snaps the input scale up to a power of two
    (:func:`pow2_scale`); every constant after it derives from the snapped
    scale.  ``stages`` and ``bottleneck`` give the family's other depths.
    """
    stages = STAGES if stages is None else stages
    folded = fold_all_bn(params_fp32, stages=stages, bottleneck=bottleneck)

    calib_x = np.asarray(calib_x, np.float32)
    bs = len(calib_x) if calib_batch_size is None else int(calib_batch_size)
    if bs < 1:
        raise ValueError(f"calib_batch_size must be >= 1, got {bs}")
    maxima: Dict[str, float] = {}
    with torch.inference_mode():
        for i in range(0, len(calib_x), bs):
            _, taps = _float_forward_taps(
                folded, torch.from_numpy(calib_x[i:i + bs]), small_input,
                stages=stages, bottleneck=bottleneck)
            for k, v in taps.items():
                m = (float(np.percentile(v.abs().numpy(), calib_percentile))
                     if calib_percentile is not None
                     else float(v.abs().max()))
                maxima[k] = max(maxima.get(k, 0.0), m)

    def scale_from_max(m):
        return max(float(m) / 127.0, 1e-12)

    s_input = scale_from_max(np.abs(calib_x).max())
    if pow2_input_scale:
        s_input = pow2_scale(s_input)
    s = {k: scale_from_max(m) for k, m in maxima.items()}

    def qconv(name, s_in, s_out, relu, in_c, k, stride, pad):
        w_q, w_s = quantize_symmetric_per_channel(folded[name], axis=0)
        return QConv(
            w2d=w_q.reshape(w_q.shape[0], -1),
            bias=bias_to_int32(folded[name + ".bias"], s_in, w_s),
            factors=requant_factors(s_in, w_s, s_out),
            in_channels=in_c, kernel=k, stride=stride, padding=pad,
            relu=relu)

    stem_k, stem_s, stem_p = (3, 1, 1) if small_input else (7, 2, 3)
    stem = qconv("conv1", s_input, s["stem"], True, 3, stem_k, stem_s,
                 stem_p)
    blocks: List[Union[QBlock, QBottleneck]] = []
    bi, in_c, s_prev = 0, 64, s["stem"]
    for si, (out_c, nblocks, stride) in enumerate(stages, start=1):
        exp_c = out_c * EXPANSION if bottleneck else out_c
        for b in range(nblocks):
            base = f"layer{si}.{b}"
            st = stride if b == 0 else 1
            c_in = in_c if b == 0 else exp_c
            ds, s_res = None, s_prev
            if f"{base}.downsample.0" in folded:
                ds = qconv(f"{base}.downsample.0", s_prev, s[f"b{bi}.ds"],
                           False, c_in, 1, st, 0)
                s_res = s[f"b{bi}.ds"]
            scales = dict(s_in=s_prev, s_res=s_res, s_out=s[f"b{bi}.out"])
            if bottleneck:
                blocks.append(QBottleneck(
                    conv1=qconv(f"{base}.conv1", s_prev, s[f"b{bi}.c1"],
                                True, c_in, 1, 1, 0),
                    conv2=qconv(f"{base}.conv2", s[f"b{bi}.c1"],
                                s[f"b{bi}.c2"], True, out_c, 3, st, 1),
                    conv3=qconv(f"{base}.conv3", s[f"b{bi}.c2"],
                                s[f"b{bi}.c3"], False, out_c, 1, 1, 0),
                    downsample=ds, s_main=s[f"b{bi}.c3"], **scales))
            else:
                blocks.append(QBlock(
                    conv1=qconv(f"{base}.conv1", s_prev, s[f"b{bi}.c1"],
                                True, c_in, 3, st, 1),
                    conv2=qconv(f"{base}.conv2", s[f"b{bi}.c1"],
                                s[f"b{bi}.c2"], False, out_c, 3, 1, 1),
                    downsample=ds, s_main=s[f"b{bi}.c2"], **scales))
            s_prev = s[f"b{bi}.out"]
            bi += 1
        in_c = exp_c

    fc_q, fc_s = quantize_symmetric_per_channel(folded["fc.weight"], axis=0)
    return ResNet18Int8(
        stem=stem, blocks=blocks, fc_w=fc_q,
        fc_b=bias_to_int32(folded["fc.bias"], s_prev, fc_s),
        fc_deq=(np.float32(s_prev) * fc_s).astype(np.float32),
        s_input=s_input, small_input=small_input, num_classes=num_classes)


# ==========================================================================
# Block sparsity
# ==========================================================================

def attach_bsr(
    model: ResNet18Int8,
    block: int = 128,
    min_sparsity: float = 0.25,
    layer_filter: Optional[Callable[[str], bool]] = None,
) -> ResNet18Int8:
    """Give every layer whose int8 weight has at least ``min_sparsity``
    block sparsity (at ``block x block`` over the (c, kh, kw) flattening
    ``w2d``) its ``BSRMatrix``; its conv then runs through the zero-skip
    kernel.  ``layer_filter(prefix) -> bool`` limits the layers
    considered.  Numerically exact either way."""
    def maybe(qc: QConv, prefix: str) -> QConv:
        if layer_filter is not None and not layer_filter(prefix):
            return qc
        bsr = build_bsr_int8_direct(qc.w2d, block)
        if bsr.sparsity_pct / 100.0 < min_sparsity:
            return qc
        return dataclasses.replace(qc, bsr=bsr)

    def convert(blk, i):
        repl = dict(conv1=maybe(blk.conv1, f"b{i}.c1"),
                    conv2=maybe(blk.conv2, f"b{i}.c2"),
                    downsample=(maybe(blk.downsample, f"b{i}.ds")
                                if blk.downsample is not None else None))
        if isinstance(blk, QBottleneck):
            repl["conv3"] = maybe(blk.conv3, f"b{i}.c3")
        return dataclasses.replace(blk, **repl)

    blocks = [convert(blk, i) for i, blk in enumerate(model.blocks)]
    return dataclasses.replace(model, stem=maybe(model.stem, "stem"),
                               blocks=blocks)


def prune_params_blockwise(
    params_fp32: Dict[str, np.ndarray],
    sparsity: float,
    block: int = 128,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Magnitude block pruning of the conv weights (a numpy copy of the
    JAX package's): each layer's [O, I*kH*kW] weight loses the
    ``int(blocks * sparsity)`` ``block x block`` blocks of least L2 norm
    (a stable argsort, so ties prune an exact quota).  The stem stays
    dense."""
    out = dict(params_fp32)
    for name, w in params_fp32.items():
        if not name.endswith(".weight") or w.ndim != 4:
            continue
        if name == "conv1.weight":
            continue
        w2 = w.reshape(w.shape[0], -1).copy()
        H, W = w2.shape
        ph, pw = -H % block, -W % block
        wp = np.pad(w2, ((0, ph), (0, pw)))
        nbr, nbc = wp.shape[0] // block, wp.shape[1] // block
        t = wp.reshape(nbr, block, nbc, block)
        norms = np.sqrt((t ** 2).sum(axis=(1, 3)))
        n_prune = int(norms.size * sparsity)
        if n_prune == 0:
            continue
        keep = np.ones(norms.size, bool)
        keep[np.argsort(norms.reshape(-1),
                        kind="stable")[:n_prune]] = False
        full = np.repeat(np.repeat(keep.reshape(norms.shape), block, 0),
                         block, 1)
        w2 *= full[:H, :W]
        out[name] = w2.reshape(w.shape).astype(np.float32)
    return out


# ==========================================================================
# Forward
# ==========================================================================

_NO_SCOPE = contextlib.nullcontext()


def _scope(name: str):
    """A ``torch.profiler`` scope named ``name`` (the rows of
    ``runtime.profile.profile_resnet18``, and ``pool``) while a profiler
    records, so that ``runtime.xprof`` can attribute each kernel's device
    time to its layer; no scope otherwise, so serving pays nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SCOPE


class Int8Conv(nn.Module):
    """One quantized conv's tensors on the device, with its geometry.

    With a dense ``weight`` the conv runs through ``conv`` (K2), or, given
    ``expand``, as a bottleneck's 1x1 c3 joined to its residual through
    ``expand`` (K7); with ``weight=None`` the layer's BSR blocks are
    uploaded instead and it runs im2col, then ``bsr`` (K4), and joins a
    residual, if given, after."""

    def __init__(self, qc: QConv, weight: Optional[torch.Tensor],
                 device: torch.device):
        super().__init__()
        self.kernel, self.stride = qc.kernel, qc.stride
        self.padding, self.relu = qc.padding, qc.relu
        self.register_buffer("weight", weight)
        self.packed = pack_bsr(qc.bsr, device) if weight is None else None
        self.register_buffer("bias", torch.from_numpy(
            np.asarray(qc.bias, np.int32)).to(device))
        self.register_buffer("factors", torch.from_numpy(
            np.asarray(qc.factors, np.float32)).to(device))

    def forward(self, x, conv=conv2d_int8, bsr=bsr_matmul_wt, residual=None,
                res_scales=None, expand=None, inv_out=None):
        if self.packed is None:
            if expand is not None:
                w = self.weight.reshape(self.weight.shape[0], -1)  # [O, C]
                return expand(x, w, self.bias, self.factors, residual,
                              *res_scales, inv_out=inv_out)
            return conv(x, self.weight, self.bias, self.factors,
                        stride=self.stride, padding=self.padding,
                        relu=self.relu, residual=residual,
                        res_scales=res_scales)
        N, _, H, W = x.shape
        Ho = (H + 2 * self.padding - self.kernel) // self.stride + 1
        Wo = (W + 2 * self.padding - self.kernel) // self.stride + 1
        a = im2col_nchw(x, self.kernel, self.stride, self.padding)
        q = bsr(a.reshape(N * Ho * Wo, -1), self.packed, bias=self.bias,
                factors=self.factors, relu=self.relu)
        # [N*Ho*Wo, O] is NHWC: as NCHW it is channels-last already
        q = q.view(N, Ho, Wo, -1).permute(0, 3, 1, 2)
        if residual is not None:
            q = add_residual(q, residual, *res_scales, relu=True).contiguous(
                memory_format=torch.channels_last)
        return q


class ResNet18Int8Module(nn.Module):
    """The quantized forward of any depth of the family on ``device``: fp32
    NCHW images, or int8 ones quantized with ``s_input``, -> fp32 logits,
    bit-exact with the golden ``forward_golden``.

    Weights are uploaded once, here, in the layouts the kernels read: the
    ImageNet stem's as OIHW and packed for K1 and K10 (``stem_k1_w``), the
    trunk's conv weights channels-last (a 1x1 c3's is then [O, C]
    row-major, as K7 reads it), the fc weight as [512 or 2048, classes].

    ``stem_fused`` (the JAX ``make_forward`` keyword) picks the ImageNet
    stem's route: True runs the fused stem (K1, or K10 for int8 images);
    False runs the space-to-depth stem (K6, then the 4x4 conv through K2,
    then the max pool) whenever H and W are even, and the fused stem
    otherwise.  Both give the same bits.  The CIFAR stem ignores it.
    """

    def __init__(self, model: ResNet18Int8, device, stem_fused: bool = True):
        super().__init__()
        device = resolve_device(device)
        self.s_input = float(model.s_input)
        self.small_input = bool(model.small_input)
        stem = model.stem
        if self.small_input:
            # The 3x3 CIFAR stem runs through the conv kernel, which takes
            # channel counts divisible by 4: a zero fourth input channel
            # (and a zero fourth weight channel) changes no sum.
            w = np.zeros((stem.w2d.shape[0], 4, 3, 3), np.int8)
            w[:, :3] = stem.w2d.reshape(-1, 3, 3, 3)
            stem_w = pack_weight(w.reshape(w.shape[0], -1), 4, 3, device)
        else:
            stem_w = torch.from_numpy(np.ascontiguousarray(
                stem.w2d.reshape(-1, stem.in_channels, 7, 7))).to(device)
        self.stem = Int8Conv(stem, stem_w, device)
        # K1's and K10's [64, 192] B operand, packed once here
        self.register_buffer("stem_k1_w", None if self.small_input
                             else pack_stem_weight(stem_w))
        self.stem_s2d_w = None
        if not (self.small_input or stem_fused):
            # [64, 4C, 4, 4]: the 7x7/s2/p3 weight regrouped for the
            # space-to-depth input, packed once here
            self.stem_s2d_w = pack_weight(
                stem_s2d_weights(stem.w2d, stem.in_channels, 7),
                4 * stem.in_channels, 4, device)
        self.blocks = nn.ModuleList()
        self.res_scales: List[Tuple[float, float, float]] = []
        # each bottleneck's proven reciprocal of s_out for K7's join, or
        # None (JAX make_forward's inv_of); None for a basic block
        self.inv_out: List[Optional[float]] = []
        for i, blk in enumerate(model.blocks):
            convs = nn.ModuleDict()
            for prefix, qc in blk.named_convs(i):
                convs[prefix.split(".")[1]] = Int8Conv(
                    qc, None if qc.bsr is not None else pack_weight(
                        qc.w2d, qc.in_channels, qc.kernel, device), device)
            self.blocks.append(convs)
            self.res_scales.append((blk.s_main, blk.s_res, blk.s_out))
            self.inv_out.append(
                exact_inv_out_scale(blk.s_main, blk.s_res, blk.s_out)
                if isinstance(blk, QBottleneck) else None)
        # [K, classes] as the .t() view of the row-major [classes, K]: the
        # K-major weight K3 takes without a copy
        self.register_buffer("fc_w", torch.from_numpy(
            np.ascontiguousarray(model.fc_w, np.int8)).to(device).t())
        self.register_buffer("fc_b", torch.from_numpy(
            np.asarray(model.fc_b, np.int32)).to(device))
        self.register_buffer("fc_deq", torch.from_numpy(
            np.asarray(model.fc_deq, np.float32)).to(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The kernels on CUDA tensors, the plain versions on CPU ones."""
        return self._forward(x, stem_conv_pool, stem_conv_pool_int8,
                             quantize_s2d, conv2d_int8, matmul_int8,
                             bsr_matmul_wt, expand_add_int8)

    def forward_plain(self, x: torch.Tensor) -> torch.Tensor:
        """The plain PyTorch versions of every kernel, on any device."""
        return self._forward(x, stem_conv_pool_plain,
                             stem_conv_pool_int8_plain, quantize_s2d_nchw,
                             conv2d_int8_plain, matmul_int8_plain,
                             bsr_matmul_wt_plain, expand_add_int8_plain)

    def _forward(self, x, stem, stem_int8, quant_s2d, conv, matmul, bsr,
                 expand):
        int8_in = x.dtype == torch.int8
        st = self.stem
        cl = torch.channels_last
        with _scope("stem"):
            if self.small_input:
                a = x if int8_in else quantize_input(x, self.s_input)
                a = F.pad(a, (0, 0, 0, 0, 0, 1))
                a = st(a.contiguous(memory_format=cl), conv)
            elif self.stem_s2d_w is not None and x.shape[-2] % 2 == 0 \
                    and x.shape[-1] % 2 == 0:
                a = (space_to_depth_nchw(x).contiguous(memory_format=cl)
                     if int8_in else quant_s2d(x, self.s_input))
                a = conv(a, self.stem_s2d_w, st.bias, st.factors, stride=1,
                         padding=((2, 1), (2, 1)), relu=st.relu)
                a = maxpool2d_int8(a, 3, 2, padding=1).contiguous(
                    memory_format=cl)
            elif int8_in:
                a = stem_int8(x, self.stem_k1_w, st.bias, st.factors)
            else:
                a = stem(x, self.stem_k1_w, st.bias, st.factors,
                         self.s_input)
        for i, (convs, rs, inv) in enumerate(zip(self.blocks,
                                                 self.res_scales,
                                                 self.inv_out)):
            with _scope(f"b{i}.c1"):
                y = convs["c1"](a, conv, bsr)
            r = a
            if "ds" in convs:
                with _scope(f"b{i}.ds"):
                    r = convs["ds"](a, conv, bsr)
            if "c3" in convs:  # a bottleneck: c2, then c3 with the join
                with _scope(f"b{i}.c2"):
                    y = convs["c2"](y, conv, bsr)
                with _scope(f"b{i}.c3"):
                    a = convs["c3"](y, conv, bsr, residual=r, res_scales=rs,
                                    expand=expand, inv_out=inv)
            else:
                with _scope(f"b{i}.c2"):
                    a = convs["c2"](y, conv, bsr, residual=r,
                                    res_scales=rs)
        with _scope("pool"):
            a = avgpool_global_int8(a)
        with _scope("fc"):
            acc = matmul(a, self.fc_w, bias=self.fc_b)
            return acc.to(torch.float32) * self.fc_deq
