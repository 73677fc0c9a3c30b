"""Plain PyTorch reference of an INT8 ResNet served by cardbench.

It takes the benchmark's raw inputs (the fp32 parameters in torchvision's
names, the fp32 calibration images and the fp32 library images) and works
out everything again from the configuration file: block pruning by L2
magnitude, BatchNorm folding, per-channel symmetric weight quantization,
abs-max calibration of the activation scales on a float32 CPU forward,
int32 biases, float32 requantization factors and the input quantization.
The forward then emulates the integer network layer by layer:

    conv: exact integer accumulators (float64 products, every partial sum
          an integer far below 2^53), + int32 bias, ReLU, float32 cast,
          float32 multiply by the factor, round half to even, saturate;
    join: float32(main) * s_main + float32(res) * s_res, divided by s_out,
          round half to even, saturate, ReLU;
    pool: window max after the stem; global average (sum + HW/2) / HW,
          truncating;
    fc:   integer accumulator + bias, float32 cast times the dequant.

``bits`` is the precision of every weight and activation: 8 is what the
configuration states; 4 is the control, the same network one precision
down, which the comparison in ``cardbench.compare`` has to reject.

Nothing here imports the program under test or JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
SCALE_EPS = 1e-12
#: Images a block of the float64 forward holds.
FORWARD_BLOCK = 128


@dataclasses.dataclass
class Inputs:
    """The raw inputs the benchmark makes from the seed and hands to both
    the program and the reference."""

    params: Dict[str, np.ndarray]   # fp32, torchvision's names
    calib: np.ndarray               # fp32 NCHW calibration images


def stage_plan(config) -> List[Tuple[int, int, int]]:
    """(width, blocks, first stride) of each stage: stride 1 in the first
    stage, 2 in the others (torchvision)."""
    return [(w, n, 1 if i == 0 else 2)
            for i, (w, n) in enumerate(zip(config["widths"],
                                           config["layers"]))]


def is_bottleneck(config) -> bool:
    return config["block"] == "bottleneck"


def expansion(config) -> int:
    return 4 if is_bottleneck(config) else 1


@dataclasses.dataclass
class Conv:
    """One trunk or stem conv: its torchvision name, geometry and role."""

    scope: str
    name: str
    bn: str
    in_c: int
    out_c: int
    kernel: int
    stride: int
    padding: int
    relu: bool


def trunk(config) -> List[List[Conv]]:
    """The convs of each residual block, in the program's scope names."""
    blocks: List[List[Conv]] = []
    in_c, bottleneck = config["stem_width"], is_bottleneck(config)
    for si, (width, n, stride) in enumerate(stage_plan(config), start=1):
        out_c = width * expansion(config)
        for b in range(n):
            i, base = len(blocks), f"layer{si}.{b}"
            st = stride if b == 0 else 1
            c_in = in_c if b == 0 else out_c
            convs = []
            if bottleneck:
                convs += [Conv(f"b{i}.c1", f"{base}.conv1", f"{base}.bn1",
                               c_in, width, 1, 1, 0, True),
                          Conv(f"b{i}.c2", f"{base}.conv2", f"{base}.bn2",
                               width, width, 3, st, 1, True),
                          Conv(f"b{i}.c3", f"{base}.conv3", f"{base}.bn3",
                               width, out_c, 1, 1, 0, False)]
            else:
                convs += [Conv(f"b{i}.c1", f"{base}.conv1", f"{base}.bn1",
                               c_in, width, 3, st, 1, True),
                          Conv(f"b{i}.c2", f"{base}.conv2", f"{base}.bn2",
                               width, width, 3, 1, 1, False)]
            if b == 0 and (st != 1 or c_in != out_c):
                convs.append(Conv(f"b{i}.ds", f"{base}.downsample.0",
                                  f"{base}.downsample.1", c_in, out_c, 1, st,
                                  0, False))
            blocks.append(convs)
        in_c = out_c
    return blocks


def stem_conv(config) -> Conv:
    k = config["stem_kernel"]
    return Conv("stem", "conv1", "bn1", config["in_channels"],
                config["stem_width"], k, config["stem_stride"], k // 2, True)


# ---- block pruning (fp32, before folding) ---------------------------------

def prune_blocks(w: np.ndarray, sparsity: float, bh: int, bw: int
                 ) -> np.ndarray:
    """``w`` [O, I, kH, kW] with the ``int(blocks * sparsity)`` blocks of
    least L2 norm of its [O, I*kH*kW] matrix (padded to whole blocks)
    zeroed; a stable order decides ties, so the quota is exact."""
    w2 = np.asarray(w, np.float32).reshape(w.shape[0], -1).copy()
    H, W = w2.shape
    wp = np.pad(w2, ((0, -H % bh), (0, -W % bw)))
    nbr, nbc = wp.shape[0] // bh, wp.shape[1] // bw
    norms = np.sqrt((wp.reshape(nbr, bh, nbc, bw) ** 2).sum(axis=(1, 3)))
    n_prune = int(norms.size * sparsity)
    if n_prune == 0:
        return np.asarray(w, np.float32)
    keep = np.ones(norms.size, bool)
    keep[np.argsort(norms.reshape(-1), kind="stable")[:n_prune]] = False
    mask = np.repeat(np.repeat(keep.reshape(nbr, nbc), bh, 0), bw, 1)
    return (w2 * mask[:H, :W]).reshape(w.shape).astype(np.float32)


def stored_blocks(w2d: np.ndarray, bh: int, bw: int) -> Dict[str, int]:
    """The nonzero ``bh`` x ``bw`` blocks of an int weight matrix: their
    count, the matrix elements they cover (edge blocks cut to the matrix)
    and the number of block rows."""
    H, W = w2d.shape
    wp = np.pad(w2d != 0, ((0, -H % bh), (0, -W % bw)))
    nbr, nbc = wp.shape[0] // bh, wp.shape[1] // bw
    nz = wp.reshape(nbr, bh, nbc, bw).any(axis=(1, 3))
    rows = np.minimum(bh, H - np.arange(nbr) * bh)
    cols = np.minimum(bw, W - np.arange(nbc) * bw)
    return {"blocks": int(nz.sum()),
            "elements": int((nz * rows[:, None] * cols[None, :]).sum()),
            "block_rows": nbr}


# ---- quantization ---------------------------------------------------------

def fold_bn(params, conv: Conv) -> Tuple[np.ndarray, np.ndarray]:
    """BatchNorm (inference) folded into the conv before it, float32."""
    g, b = params[f"{conv.bn}.weight"], params[f"{conv.bn}.bias"]
    mean = params[f"{conv.bn}.running_mean"]
    var = params[f"{conv.bn}.running_var"]
    scale = g / np.sqrt(var + BN_EPS)
    w = params[f"{conv.name}.weight"] * scale[:, None, None, None]
    return w.astype(np.float32), (b - mean * scale).astype(np.float32)


def quantize_weight(w: np.ndarray, qmax: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per output channel: max|w| -> qmax; (q, scales)."""
    w = np.asarray(w, np.float32)
    axes = tuple(range(1, w.ndim))
    maxabs = np.max(np.abs(w), axis=axes, keepdims=True)
    scales = np.maximum(maxabs / float(qmax), SCALE_EPS)
    q = np.clip(np.rint(w / scales), -qmax - 1, qmax)
    return q.astype(np.int8), scales.reshape(-1).astype(np.float32)


def int_bias(bias: np.ndarray, s_in: float, w_scales: np.ndarray
             ) -> np.ndarray:
    """The bias in the accumulator's units, rounded and saturated to
    int32."""
    q = np.rint(np.asarray(bias, np.float64)
                / (float(s_in) * np.asarray(w_scales, np.float64)))
    q = np.nan_to_num(q, nan=0.0, posinf=2**31 - 1, neginf=-2**31)
    return np.clip(q, -2**31, 2**31 - 1).astype(np.int64)


def factors(s_in: float, w_scales: np.ndarray, s_out: float) -> np.ndarray:
    return ((np.float32(s_in) * w_scales.astype(np.float32))
            / np.float32(s_out)).astype(np.float32)


def calibration_maxima(folded, config, calib: np.ndarray
                       ) -> Dict[str, float]:
    """abs-max of every activation the int8 network requantizes, on a
    float32 forward of the folded network over ``calib`` on the CPU."""
    taps: Dict[str, torch.Tensor] = {}

    def conv(c: Conv, a):
        w, b = folded[c.scope]
        return F.conv2d(a, torch.from_numpy(w), stride=c.stride,
                        padding=c.padding) + torch.from_numpy(b)[
                            None, :, None, None]

    with torch.inference_mode():
        a = conv(stem_conv(config), torch.from_numpy(calib)).clamp_min(0)
        taps["stem"] = a
        a = F.max_pool2d(a, 3, 2, padding=1)
        for convs in trunk(config):
            by = {c.scope.split(".")[1]: c for c in convs}
            i = convs[0].scope.split(".")[0]
            y = a
            for role in ("c1", "c2", "c3"):
                if role in by:
                    y = conv(by[role], y)
                    if by[role].relu:
                        y = y.clamp_min(0)
                    taps[f"{i}.{role}"] = y
            r = a
            if "ds" in by:
                r = conv(by["ds"], a)
                taps[f"{i}.ds"] = r
            a = (y + r).clamp_min(0)
            taps[f"{i}.out"] = a
        taps["fc_in"] = a.mean(dim=(2, 3))
        return {k: float(v.abs().max()) for k, v in taps.items()}


@dataclasses.dataclass
class QLayer:
    conv: Conv
    w: np.ndarray            # int, [O, C, k, k]
    bias: np.ndarray         # int64 [O]
    factors: np.ndarray      # float32 [O]


class Reference:
    """The INT8 (or, with ``bits=4``, INT4) network of ``config`` derived
    from the raw ``inputs``."""

    def __init__(self, config, inputs: Inputs, bits: int = 8):
        self.config, self.bits = config, bits
        params, calib = inputs.params, inputs.calib
        self.qmax = 2 ** (bits - 1) - 1
        self.qmin = -self.qmax - 1
        sp = config.get("sparsity")
        params = dict(params)
        if sp:
            bh, bw = sp["block"]
            for convs in trunk(config):
                for c in convs:
                    key = f"{c.name}.weight"
                    params[key] = prune_blocks(params[key], sp["target"],
                                               bh, bw)
        self.blocks = trunk(config)
        convs = [stem_conv(config)] + [c for b in self.blocks for c in b]
        folded = {c.scope: fold_bn(params, c) for c in convs}
        calib = np.asarray(calib, np.float32)
        maxima = calibration_maxima(folded, config, calib)
        qmax = self.qmax

        def scale(m):
            return max(float(m) / float(qmax), SCALE_EPS)

        self.s_input = scale(np.abs(calib).max())
        s = {k: scale(m) for k, m in maxima.items()}
        self.layers: Dict[str, QLayer] = {}
        self.scales: Dict[str, Tuple[float, float, float]] = {}

        def add(c: Conv, s_in: float, s_out: float):
            w, b = folded[c.scope]
            q, ws = quantize_weight(w, qmax)
            self.layers[c.scope] = QLayer(c, q, int_bias(b, s_in, ws),
                                          factors(s_in, ws, s_out))

        add(stem_conv(config), self.s_input, s["stem"])
        s_prev = s["stem"]
        for convs in self.blocks:
            by = {c.scope.split(".")[1]: c for c in convs}
            i = convs[0].scope.split(".")[0]
            s_in = s_prev
            for role in ("c1", "c2", "c3"):
                if role in by:
                    add(by[role], s_in, s[f"{i}.{role}"])
                    s_in = s[f"{i}.{role}"]
            s_res = s_prev
            if "ds" in by:
                add(by["ds"], s_prev, s[f"{i}.ds"])
                s_res = s[f"{i}.ds"]
            self.scales[i] = (s_in, s_res, s[f"{i}.out"])
            s_prev = s[f"{i}.out"]
        fc_q, fc_s = quantize_weight(params["fc.weight"], qmax)
        self.fc_w = fc_q
        self.fc_b = int_bias(params["fc.bias"], s_prev, fc_s)
        self.fc_deq = (np.float32(s_prev) * fc_s).astype(np.float32)

    # ---- what the configuration's sparsity left stored -------------------

    def stored(self) -> Dict[str, Dict[str, int]]:
        """Each trunk conv's nonzero blocks (``stored_blocks``) at the
        configuration's block shape; empty for a dense configuration."""
        sp = self.config.get("sparsity")
        if not sp:
            return {}
        bh, bw = sp["block"]
        return {scope: stored_blocks(ql.w.reshape(ql.w.shape[0], -1), bh, bw)
                for scope, ql in self.layers.items() if scope != "stem"}

    def state_checks(self, state: Dict[str, int]
                     ) -> List[Tuple[str, int, int]]:
        """``sparse_layers_off``: the convs whose stored blocks in the
        program's ``state`` differ from the reference's pruning, or that
        one side serves block-sparse and the other does not."""
        want = {scope: s["blocks"] for scope, s in self.stored().items()}
        off = sum(want.get(s) != state.get(s) for s in set(want) | set(state))
        return [("sparse_layers_off", off, 0)]

    # ---- the integer forward ----------------------------------------------

    def quantize_input(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.tensor([self.s_input], dtype=torch.float32, device=x.device)
        return torch.round(x.to(torch.float32) / s).clamp(self.qmin,
                                                          self.qmax)

    def _conv(self, x: torch.Tensor, scope: str, dev) -> torch.Tensor:
        """Requantized output of layer ``scope`` on integer-valued float64
        ``x``, as integer-valued float64."""
        ql = self.layers[scope]
        c = ql.conv
        w = torch.from_numpy(ql.w.astype(np.float64)).to(dev)
        N, C, H, W = x.shape
        Ho = (H + 2 * c.padding - c.kernel) // c.stride + 1
        Wo = (W + 2 * c.padding - c.kernel) // c.stride + 1
        if c.kernel == 1:
            xs = x[:, :, ::c.stride, ::c.stride]
            acc = torch.matmul(w.reshape(c.out_c, C),
                               xs.reshape(N, C, Ho * Wo))
        else:
            cols = F.unfold(x, c.kernel, padding=c.padding, stride=c.stride)
            acc = torch.matmul(w.reshape(c.out_c, -1), cols)
        acc = acc.reshape(N, c.out_c, Ho, Wo).to(torch.int64)
        acc = acc + torch.from_numpy(ql.bias).to(dev).view(1, -1, 1, 1)
        if c.relu:
            acc = acc.clamp_min(0)
        f = torch.from_numpy(ql.factors).to(dev).view(1, -1, 1, 1)
        y = torch.round(acc.to(torch.float32) * f).clamp(self.qmin,
                                                         self.qmax)
        return y.to(torch.float64)

    def _join(self, main, res, scales, dev) -> torch.Tensor:
        sm, sr, so = (torch.tensor([v], dtype=torch.float32, device=dev)
                      for v in scales)
        t = main.to(torch.float32) * sm + res.to(torch.float32) * sr
        q = torch.round(t / so).clamp(self.qmin, self.qmax).clamp_min(0)
        return q.to(torch.float64)

    def forward_int(self, q: torch.Tensor) -> torch.Tensor:
        """Logits (float32) of integer-valued images ``q`` [N, C, H, W]."""
        dev = q.device
        a = self._conv(q.to(torch.float64), "stem", dev)
        a = F.max_pool2d(a, 3, 2, padding=1)
        for convs in self.blocks:
            by = {c.scope.split(".")[1]: c.scope for c in convs}
            i = convs[0].scope.split(".")[0]
            y = a
            for role in ("c1", "c2", "c3"):
                if role in by:
                    y = self._conv(y, by[role], dev)
            r = self._conv(a, by["ds"], dev) if "ds" in by else a
            a = self._join(y, r, self.scales[i], dev)
        hw = a.shape[-2] * a.shape[-1]
        s = a.to(torch.int64).sum(dim=(2, 3)) + hw // 2
        p = torch.div(s, hw, rounding_mode="trunc").clamp(self.qmin,
                                                          self.qmax)
        w = torch.from_numpy(self.fc_w.astype(np.float64)).to(dev)
        acc = torch.matmul(p.to(torch.float64), w.t()).to(torch.int64)
        acc = acc + torch.from_numpy(self.fc_b).to(dev)
        deq = torch.from_numpy(self.fc_deq).to(dev)
        return acc.to(torch.float32) * deq

    def logits(self, x: torch.Tensor,
               block: Optional[int] = None) -> torch.Tensor:
        """Logits of fp32 images ``x`` (on any device), computed there in
        blocks of ``block`` images; returned on the CPU."""
        block = block or FORWARD_BLOCK
        out = []
        with torch.inference_mode():
            for i in range(0, x.shape[0], block):
                out.append(self.forward_int(
                    self.quantize_input(x[i:i + block])).cpu())
        return torch.cat(out)
