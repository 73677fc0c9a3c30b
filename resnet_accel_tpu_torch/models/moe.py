"""INT8 block-sparse Mixture-of-Experts MLP, the expert-parallel model.

Counterpart of ``resnet_accel_tpu/models/moe.py``: a top-1 routed MoE
feed-forward block whose expert MLPs are per-channel int8 BSR projections
(the transformer block's machinery) behind a small float32 linear router.
``MoEBlockInt8`` holds the numpy data (the seeded ``from_random``, the same
numbers as the JAX package's, and the numpy ``forward_golden``);
``MoEBlockInt8Module`` runs it on a device, all experts or a given subset
of them (``parallel/experts.py`` shards them over an ``ep`` axis).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from resnet_accel_tpu_torch.models.attention import (
    SparseProjection, projection_from_reference)
from resnet_accel_tpu_torch.models.transformer import _gelu_np, \
    _make_projection
from resnet_accel_tpu_torch.ops.epilogue import scalar_f32
from resnet_accel_tpu_torch.ops.flash_attention import fp32_matmuls
from resnet_accel_tpu_torch.runtime.backend import resolve_device
from resnet_accel_tpu_torch.sparse.fixtures import create_sparse_mask


@dataclasses.dataclass
class Expert:
    w1: SparseProjection     # d_model -> d_ff
    w2: SparseProjection     # d_ff -> d_model


@dataclasses.dataclass
class MoEBlockInt8:
    experts: List[Expert]
    router_w: np.ndarray     # [E, d_model] float32

    @classmethod
    def from_random(cls, n_experts: int = 4, d_model: int = 128,
                    d_ff: int = 256, sparsity: float = 0.8, block: int = 8,
                    seed: int = 0) -> "MoEBlockInt8":
        rng = np.random.default_rng(seed)

        def w(o, i, s):
            base = rng.normal(0, 1.0 / np.sqrt(i), (o, i)).astype(np.float32)
            return base * create_sparse_mask((o, i), block, sparsity,
                                             seed=s)

        experts = []
        for e in range(n_experts):
            experts.append(Expert(
                w1=_make_projection(
                    w(d_ff, d_model, seed + 10 + e), block,
                    rng.normal(0, 0.01, d_ff).astype(np.float32)),
                w2=_make_projection(
                    w(d_model, d_ff, seed + 50 + e), block,
                    rng.normal(0, 0.01, d_model).astype(np.float32)),
            ))
        router = rng.normal(0, 0.1, (n_experts, d_model)).astype(np.float32)
        return cls(experts=experts, router_w=router)

    @property
    def n_experts(self) -> int:
        return len(self.experts)

    def sparsity_report(self) -> Dict[str, float]:
        return {f"expert{e}": ex.w1.bsr.sparsity_pct / 100.0
                for e, ex in enumerate(self.experts)}

    def module(self, device="cuda", experts: Optional[Iterable[int]] = None
               ) -> "MoEBlockInt8Module":
        return MoEBlockInt8Module(self, device, experts)

    def forward_golden(self, x: np.ndarray) -> np.ndarray:
        """Numpy reference of the dense-compute-and-mask formulation (the
        dynamic quantization scales over the full token set per expert)."""
        logits = x @ self.router_w.T
        sel = np.argmax(logits, axis=-1)
        out = np.zeros_like(x, dtype=np.float32)
        scale = max(float(np.abs(x).max()) / 127.0, 1e-12)
        q = np.clip(np.rint(x / scale), -128, 127).astype(np.int8)
        for e, ex in enumerate(self.experts):
            z = ex.w1.project_golden(q, scale)
            gelu = _gelu_np(z)
            s2 = max(float(np.abs(gelu).max()) / 127.0, 1e-12)
            q2 = np.clip(np.rint(gelu / s2), -128, 127).astype(np.int8)
            y = ex.w2.project_golden(q2, s2)
            mask = sel == e
            out[mask] = y[mask]
        return out


def from_reference(moe) -> MoEBlockInt8:
    """Carry the JAX package's ``MoEBlockInt8`` across: each expert's BSR
    projections and the router, as numpy."""
    return MoEBlockInt8(
        experts=[Expert(w1=projection_from_reference(ex.w1),
                        w2=projection_from_reference(ex.w2))
                 for ex in moe.experts],
        router_w=np.asarray(moe.router_w, np.float32))


class MoEBlockInt8Module(nn.Module):
    """A :class:`MoEBlockInt8` on ``device``: the router and the experts
    named by ``experts`` (default: all).  Products in float32 with TF32
    off; each token's output is its routed expert's, selected exactly."""

    def __init__(self, moe: MoEBlockInt8, device="cuda",
                 experts: Optional[Iterable[int]] = None):
        super().__init__()
        self.device = resolve_device(device)
        fp32_matmuls()
        ids = range(moe.n_experts) if experts is None else experts
        self.experts = {int(e): (moe.experts[e].w1.to(self.device),
                                 moe.experts[e].w2.to(self.device))
                        for e in ids}
        self.register_buffer("router_w", torch.from_numpy(
            np.asarray(moe.router_w, np.float32)).to(self.device))
        self.n_experts = moe.n_experts
        self._c127 = scalar_f32(127.0, self.device)

    def route(self, x: torch.Tensor) -> torch.Tensor:
        """Top-1 expert index per token (argmax of the router logits)."""
        return torch.argmax(x @ self.router_w.T, dim=-1)

    def _q_dyn(self, x):
        s = torch.clamp_min(x.abs().max() / self._c127, 1e-12)
        return torch.round(x / s).clamp(-128, 127).to(torch.int8), s

    def _expert_fwd(self, e: int, x: torch.Tensor) -> torch.Tensor:
        w1, w2 = self.experts[e]
        h = F.gelu(w1.project(*self._q_dyn(x)), approximate="tanh")
        return w2.project(*self._q_dyn(h))

    def masked(self, x: torch.Tensor, sel: torch.Tensor,
               ids: Iterable[int]) -> torch.Tensor:
        """The tokens routed to the experts ``ids`` through them, zeros
        elsewhere: every expert runs on every token, masked select."""
        out = torch.zeros_like(x)
        for e in ids:
            out = torch.where((sel == e)[:, None], self._expert_fwd(e, x),
                              out)
        return out

    @torch.inference_mode()
    def forward(self, x) -> torch.Tensor:
        """[T, d_model] -> [T, d_model]: each token through its expert."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        return self.masked(x, self.route(x), range(self.n_experts))
