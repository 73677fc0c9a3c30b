"""The MNIST CNN in INT8, the reference's own end-to-end model, in PyTorch.

Counterpart of ``resnet_accel_tpu/models/mnist_cnn.py``::

    conv1 1->32 3x3 s1 p0 -> ReLU -> conv2 32->64 3x3 s1 p0 -> ReLU
    -> maxpool 2x2 -> flatten (NCHW order, 64*12*12 = 9216)
    -> fc1 9216->128 -> ReLU -> fc2 128->10

- ``MNISTCNNInt8`` holds the quantized model as numpy arrays with the
  precomputed float32 requant factors; ``from_int8_dir`` reads the
  reference's int8 export and calibrates the activation scales with the
  same numpy float forward as the JAX package, so the scales are
  bit-identical; ``with_fc1_bsr`` gives fc1 its ``BSRMatrix``.
- ``MNISTCNNInt8Module`` is the forward (fp32 [N, 1, 28, 28] -> fp32
  logits): quantize_input -> conv2d_int8 (K2) twice -> maxpool2d_int8 ->
  flatten -> fc1 through bsr_matmul_wt (K4) when it has BSR weights, else
  matmul_int8 (K3), with bias, ReLU and requant -> fc2 through
  matmul_int8 (K3) -> x fc2_deq.  The plain versions run on CPU tensors
  and in ``forward_plain``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from resnet_accel_tpu_torch.models.resnet18 import bsr_from_reference
from resnet_accel_tpu_torch.ops import (
    bsr_matmul_wt,
    bsr_matmul_wt_plain,
    conv2d_int8,
    conv2d_int8_plain,
    matmul_int8,
    matmul_int8_plain,
    maxpool2d_int8,
    pack_bsr,
    pack_weight,
    quantize_input,
    requant_factors,
)
from resnet_accel_tpu_torch.quant import bias_to_int32
from resnet_accel_tpu_torch.runtime.backend import resolve_device
from resnet_accel_tpu_torch.sparse.bsr import BSRMatrix, build_bsr_int8_direct

#: MNIST normalization constants.
MNIST_MEAN, MNIST_STD = 0.1307, 0.3081

_LAYERS = ("conv1", "conv2", "fc1", "fc2")


@dataclasses.dataclass
class MNISTCNNInt8:
    """All static data of INT8 MNIST inference."""

    conv1_w: np.ndarray      # [32, 9] int8, flattened OIHW
    conv2_w: np.ndarray      # [64, 288]
    fc1_w: np.ndarray        # [128, 9216]
    fc2_w: np.ndarray        # [10, 128]
    conv1_b: np.ndarray      # int32, accumulator domain
    conv2_b: np.ndarray
    fc1_b: np.ndarray
    fc2_b: np.ndarray
    act_scales: Tuple[float, float, float, float]  # input, conv1, conv2, fc1
    fc2_w_scales: np.ndarray
    conv1_f: np.ndarray      # float32 requant factors
    conv2_f: np.ndarray
    fc1_f: np.ndarray
    fc1_bsr: Optional[BSRMatrix] = None  # zero-skip weights of fc1

    @classmethod
    def from_arrays(
        cls,
        weights: Dict[str, np.ndarray],
        weight_scales: Dict[str, np.ndarray],
        biases_fp32: Dict[str, np.ndarray],
        act_scales: Tuple[float, float, float, float],
    ) -> "MNISTCNNInt8":
        """Build from int8 weights, fp32 biases and calibrated activation
        scales."""
        s0, s1, s2, s3 = act_scales
        return cls(
            conv1_w=weights["conv1"].reshape(32, -1),
            conv2_w=weights["conv2"].reshape(64, -1),
            fc1_w=weights["fc1"], fc2_w=weights["fc2"],
            conv1_b=bias_to_int32(biases_fp32["conv1"], s0,
                                  weight_scales["conv1"]),
            conv2_b=bias_to_int32(biases_fp32["conv2"], s1,
                                  weight_scales["conv2"]),
            fc1_b=bias_to_int32(biases_fp32["fc1"], s2,
                                weight_scales["fc1"]),
            fc2_b=bias_to_int32(biases_fp32["fc2"], s3,
                                weight_scales["fc2"]),
            act_scales=(s0, s1, s2, s3),
            fc2_w_scales=np.asarray(weight_scales["fc2"], np.float32),
            conv1_f=requant_factors(s0, weight_scales["conv1"], s1),
            conv2_f=requant_factors(s1, weight_scales["conv2"], s2),
            fc1_f=requant_factors(s2, weight_scales["fc1"], s3),
        )

    @classmethod
    def from_int8_dir(
        cls, int8_dir: str, calib_inputs: np.ndarray
    ) -> "MNISTCNNInt8":
        """Load the reference's int8 export (per layer
        ``{layer}_weight_int8.npy``, ``{layer}_weight_scales.npy``,
        ``{layer}_bias_int8.npy`` and ``{layer}_bias_scale.json``) and
        calibrate the activation scales on ``calib_inputs``, raw images
        [N, 28, 28] (pixels in 0..255 are normalized here)."""
        weights, scales, biases = {}, {}, {}
        for layer in _LAYERS:
            weights[layer] = np.load(
                os.path.join(int8_dir, f"{layer}_weight_int8.npy"))
            scales[layer] = np.load(
                os.path.join(int8_dir, f"{layer}_weight_scales.npy"))
            b_i8 = np.load(os.path.join(int8_dir, f"{layer}_bias_int8.npy"))
            with open(os.path.join(int8_dir,
                                   f"{layer}_bias_scale.json")) as f:
                b_scale = json.load(f)["scale"]
            biases[layer] = b_i8.astype(np.float32) * np.float32(b_scale)

        x = calib_inputs.astype(np.float32)
        if x.max() > 4.0:  # raw pixels -> normalize
            x = x / 255.0
        x = (x - MNIST_MEAN) / MNIST_STD
        x = x.reshape(-1, 1, 28, 28)
        act_scales = _calibrate_act_scales(x, weights, scales, biases)
        return cls.from_arrays(weights, scales, biases, act_scales)

    def with_fc1_bsr(self, block: int = 128) -> "MNISTCNNInt8":
        """The same model with fc1's ``BSRMatrix`` at ``block x block``:
        fc1 then runs through the zero-skip kernel (block-pruned weights
        give zero blocks; dense weights work too, with nothing skipped)."""
        return dataclasses.replace(
            self, fc1_bsr=build_bsr_int8_direct(self.fc1_w, block))

    def sparsity_report(self) -> Dict[str, float]:
        if self.fc1_bsr is None:
            return {}
        return {"fc1": 1.0 - self.fc1_bsr.nnz_blocks
                / self.fc1_bsr.total_blocks}


def from_reference(model) -> MNISTCNNInt8:
    """Carry the JAX package's ``MNISTCNNInt8`` across (numpy attributes
    only); a packed fc1 BSR is rebuilt from ``fc1_w`` at its block shape
    and must count the same blocks."""
    arrays = {f.name: np.asarray(getattr(model, f.name))
              for f in dataclasses.fields(MNISTCNNInt8)
              if f.name not in ("act_scales", "fc1_bsr")}
    return MNISTCNNInt8(
        **arrays, act_scales=tuple(float(s) for s in model.act_scales),
        fc1_bsr=bsr_from_reference(arrays["fc1_w"], model.fc1_bsr))


def _calibrate_act_scales(x, weights, scales, biases):
    """Float forward with dequantized weights to observe the activation
    ranges (a numpy copy of the JAX package's, so the scales agree bit for
    bit)."""
    def deq(layer):
        w = weights[layer].astype(np.float32)
        s = scales[layer].reshape((-1,) + (1,) * (w.ndim - 1))
        return w * s

    s0 = max(float(np.abs(x).max()) / 127.0, 1e-12)
    a = _conv_f32(x, deq("conv1"), biases["conv1"])
    a = np.maximum(a, 0)
    s1 = max(float(np.abs(a).max()) / 127.0, 1e-12)
    a = _conv_f32(a, deq("conv2"), biases["conv2"])
    a = np.maximum(a, 0)
    s2 = max(float(np.abs(a).max()) / 127.0, 1e-12)
    N, C, H, W = a.shape
    a = a.reshape(N, C, H // 2, 2, W // 2, 2).max(axis=(3, 5))
    a = a.reshape(N, -1)
    a = a @ deq("fc1").T + biases["fc1"]
    a = np.maximum(a, 0)
    s3 = max(float(np.abs(a).max()) / 127.0, 1e-12)
    return (s0, s1, s2, s3)


def _conv_f32(x, w, b):
    """Tiny float conv (valid, stride 1), for calibration only."""
    N, C, H, W = x.shape
    O, _, K, _ = w.shape
    Ho, Wo = H - K + 1, W - K + 1
    cols = np.stack([
        x[:, :, kh:kh + Ho, kw:kw + Wo]
        for kh in range(K) for kw in range(K)
    ], axis=-1)                                    # [N,C,Ho,Wo,K*K]
    cols = cols.transpose(0, 2, 3, 1, 4).reshape(N, Ho * Wo, C * K * K)
    out = cols @ w.reshape(O, -1).T + b
    return out.reshape(N, Ho, Wo, O).transpose(0, 3, 1, 2)


class MNISTCNNInt8Module(nn.Module):
    """The quantized MNIST CNN on ``device``: fp32 [N, 1, 28, 28] ->
    fp32 logits [N, 10], bit-exact with the golden ``forward_golden``."""

    def __init__(self, model: MNISTCNNInt8, device):
        super().__init__()
        device = resolve_device(device)
        self.s_input = float(model.act_scales[0])

        def put(arr, dtype):
            return torch.from_numpy(np.ascontiguousarray(arr, dtype)).to(
                device)

        # conv1's single input channel runs through the conv kernel, which
        # takes channel counts divisible by 4: three zero channels (and
        # zero weights for them) change no sum.
        w1 = np.zeros((32, 4, 3, 3), np.int8)
        w1[:, :1] = model.conv1_w.reshape(32, 1, 3, 3)
        self.register_buffer("conv1_w", pack_weight(
            w1.reshape(32, -1), 4, 3, device))
        self.register_buffer("conv2_w", pack_weight(
            model.conv2_w, 32, 3, device))
        for name in _LAYERS:
            self.register_buffer(f"{name}_b", put(
                getattr(model, f"{name}_b"), np.int32))
        for name in ("conv1", "conv2", "fc1"):
            self.register_buffer(f"{name}_f", put(
                getattr(model, f"{name}_f"), np.float32))
        self.fc1_packed = None
        if model.fc1_bsr is not None:
            self.fc1_packed = pack_bsr(model.fc1_bsr, device)
        # [K, N] as .t() views of the row-major [N, K]: the K-major
        # weights K3 takes without a copy
        self.register_buffer("fc1_wT", None if model.fc1_bsr is not None
                             else put(model.fc1_w, np.int8).t())
        self.register_buffer("fc2_wT", put(model.fc2_w, np.int8).t())
        self.register_buffer("fc2_deq", put(
            np.float32(model.act_scales[3]) * model.fc2_w_scales,
            np.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The kernels on CUDA tensors, the plain versions on CPU ones."""
        return self._forward(x, conv2d_int8, matmul_int8, bsr_matmul_wt)

    def forward_plain(self, x: torch.Tensor) -> torch.Tensor:
        """The plain PyTorch versions of every kernel, on any device."""
        return self._forward(x, conv2d_int8_plain, matmul_int8_plain,
                             bsr_matmul_wt_plain)

    def _forward(self, x, conv, matmul, bsr):
        a = F.pad(quantize_input(x, self.s_input), (0, 0, 0, 0, 0, 3))
        a = conv(a.contiguous(memory_format=torch.channels_last),
                 self.conv1_w, self.conv1_b, self.conv1_f, relu=True)
        a = conv(a, self.conv2_w, self.conv2_b, self.conv2_f, relu=True)
        a = maxpool2d_int8(a, 2, 2)
        # fc1's columns are in (c, h, w) order: flatten the NCHW tensor,
        # not the channels-last memory the conv kernel wrote
        a = a.contiguous().reshape(a.shape[0], -1)
        if self.fc1_packed is not None:
            a = bsr(a, self.fc1_packed, bias=self.fc1_b,
                    factors=self.fc1_f, relu=True)
        else:
            a = matmul(a, self.fc1_wT, bias=self.fc1_b, factors=self.fc1_f,
                       relu=True)
        acc = matmul(a, self.fc2_wT, bias=self.fc2_b)
        return acc.to(torch.float32) * self.fc2_deq
