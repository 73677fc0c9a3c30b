"""INT8 block-sparse transformer block, in PyTorch.

Counterpart of ``resnet_accel_tpu/models/transformer.py``::

    x -> LN -> multi-head attention (Q, K, V, O int8-sparse projections) -> +x
      -> LN -> MLP (W1 -> GELU -> W2, int8-sparse) -> +residual

- ``TransformerBlockInt8`` holds the block as numpy data (the six
  :class:`SparseProjection` and the LayerNorm parameters), with the seeded
  ``from_random``, the numpy golden ``forward_golden`` and
  ``calibrate_scales``, which give the same numbers as the JAX package's,
  bit for bit.
- ``TransformerBlockInt8Module`` is the block on a device: the full causal
  forward (einsum attention, or kernel K5 with ``flash=True``), the KV-cache
  ``prefill``, the one-token ``decode_step`` and the S-token
  ``verify_step`` of speculative decoding.  Activations quantize to int8 at
  each projection input, with static per-tap scales (Python floats,
  rounded once to float32) or, without them, one dynamic scale per
  sequence.  LayerNorm, softmax, GELU and the residuals are float32, with
  TF32 off, but on the decode path (below).  Every function takes leading
  batch dimensions.

**Rows that do not depend on their neighbours.**  Greedy speculative
decoding equals ``generate`` only if each row of a verify pass computes
what one ``decode_step`` computes, and a batcher's slot what a lone
request computes.  A float32 reduction does not promise that: cuBLAS picks
its kernel, and PyTorch its reduction layout, from the number of rows, and
each sums in its own order.  So every reduction of the decode path
(``decode_step``, ``verify_step``, ``attend_mlp_multi``: the LayerNorm
statistics, the attention logits, softmax and context, and the LM's
readout) runs in float64 and is rounded once to float32; the helpers take
``rows=True`` for it.  Float32 inputs give exact float64 products, and a
float64 sum of a few thousand of them rounds to the same float32 value in
any order unless it lies within about 2^-40 (relative) of a rounding
boundary.  The projections are exact already (integer sums in float64).
Masked positions add exact zeros, so a view padded to any length gives
the same rows.  The LM's teacher-forced forward takes ``rows=True`` too:
the paged engine's ``score()`` is held to it.  The parallel prefill keeps
float32: ``generate``, ``sample`` and ``generate_speculative`` prefill a
prompt through the same call at the same shape, and nothing else compares
its rows.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from resnet_accel_tpu_torch.models.attention import (
    PackedProjection,
    SparseProjection,
)
from resnet_accel_tpu_torch.ops.epilogue import scalar_f32
from resnet_accel_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_plain,
    fp32_matmuls,
)
from resnet_accel_tpu_torch.quant import quantize_symmetric_per_channel
from resnet_accel_tpu_torch.runtime.backend import resolve_device
from resnet_accel_tpu_torch.sparse.bsr import build_bsr
from resnet_accel_tpu_torch.sparse.fixtures import create_sparse_mask

LN_EPS = 1e-5
PROJECTIONS = ("wq", "wk", "wv", "wo", "w1", "w2")


def _make_projection(w_fp32: np.ndarray, block: int,
                     bias: Optional[np.ndarray]) -> SparseProjection:
    _, scales = quantize_symmetric_per_channel(w_fp32, axis=0)
    bsr = build_bsr(w_fp32, block, threshold=1e-10, quantize=True,
                    scales=scales)
    return SparseProjection(bsr=bsr, scales=scales, bias=bias)


def layer_norm_np(v, gamma, beta):
    mu = v.mean(axis=-1, keepdims=True)
    var = v.var(axis=-1, keepdims=True)
    return (v - mu) / np.sqrt(var + LN_EPS) * gamma + beta


def _gelu_np(z):
    return 0.5 * z * (1.0 + np.tanh(
        np.sqrt(2.0 / np.pi) * (z + 0.044715 * z ** 3)))


@dataclasses.dataclass
class TransformerBlockInt8:
    """One block with INT8 block-sparse projections (numpy data)."""

    wq: SparseProjection
    wk: SparseProjection
    wv: SparseProjection
    wo: SparseProjection
    w1: SparseProjection      # d_model -> d_ff
    w2: SparseProjection      # d_ff -> d_model
    ln1_g: np.ndarray
    ln1_b: np.ndarray
    ln2_g: np.ndarray
    ln2_b: np.ndarray
    n_heads: int

    @classmethod
    def from_random(
        cls,
        d_model: int = 128,
        n_heads: int = 4,
        d_ff: int = 256,
        sparsity: float = 0.8,
        block: int = 8,
        seed: int = 0,
    ) -> "TransformerBlockInt8":
        """Seeded block-sparse random block, the same numbers as the JAX
        package's ``from_random`` with the same arguments."""
        rng = np.random.default_rng(seed)

        def w(o, i, s):
            base = rng.normal(0, 1.0 / np.sqrt(i), (o, i)).astype(np.float32)
            return base * create_sparse_mask((o, i), block, sparsity,
                                             seed=s)

        def b(o):
            return rng.normal(0, 0.01, o).astype(np.float32)

        return cls(
            wq=_make_projection(w(d_model, d_model, seed + 1), block,
                                b(d_model)),
            wk=_make_projection(w(d_model, d_model, seed + 2), block,
                                b(d_model)),
            wv=_make_projection(w(d_model, d_model, seed + 3), block,
                                b(d_model)),
            wo=_make_projection(w(d_model, d_model, seed + 4), block,
                                b(d_model)),
            w1=_make_projection(w(d_ff, d_model, seed + 5), block,
                                b(d_ff)),
            w2=_make_projection(w(d_model, d_ff, seed + 6), block,
                                b(d_model)),
            ln1_g=np.ones(d_model, np.float32),
            ln1_b=np.zeros(d_model, np.float32),
            ln2_g=np.ones(d_model, np.float32),
            ln2_b=np.zeros(d_model, np.float32),
            n_heads=n_heads,
        )

    @property
    def d_model(self) -> int:
        return self.wq.d_in

    def sparsity_report(self) -> Dict[str, float]:
        return {name: getattr(self, name).bsr.sparsity_pct / 100.0
                for name in PROJECTIONS}

    # ------------------------------------------------------------ golden
    @staticmethod
    def _q_dyn_np(x):
        scale = max(float(np.abs(x).max()) / 127.0, 1e-12)
        q = np.clip(np.rint(x / scale), -128, 127).astype(np.int8)
        return q, scale

    def calibrate_scales(self, x: np.ndarray) -> Dict[str, float]:
        """Static activation scales for serving: absmax / 127 at each
        projection input, observed on the calibration sequence ``x``
        [T, d_model] with the golden's dynamic scales (float64 scale
        arithmetic, as the JAX package's numpy calibration)."""
        obs = {}
        h = layer_norm_np(x, self.ln1_g, self.ln1_b)
        obs["h1"] = float(np.abs(h).max())
        T, D = x.shape
        Hh = self.n_heads
        dh = D // Hh
        q1, s1 = self._q_dyn_np(h)
        qh = self.wq.project_golden(q1, s1).reshape(T, Hh, dh)
        kh = self.wk.project_golden(q1, s1).reshape(T, Hh, dh)
        vh = self.wv.project_golden(q1, s1).reshape(T, Hh, dh)
        qe = qh.transpose(1, 0, 2)
        ke = kh.transpose(1, 0, 2)
        ve = vh.transpose(1, 0, 2)
        logits = np.einsum("htd,hsd->hts", qe, ke) / np.sqrt(np.float32(dh))
        e = np.exp(logits - logits.max(axis=-1, keepdims=True))
        attn = e / e.sum(axis=-1, keepdims=True)
        ctx = np.einsum("hts,hsd->htd", attn, ve).transpose(1, 0, 2)
        ctx = ctx.reshape(T, D)
        obs["ctx"] = float(np.abs(ctx).max())
        x2 = x + self.wo.project_golden(*self._q_dyn_np(ctx))
        h2 = layer_norm_np(x2, self.ln2_g, self.ln2_b)
        obs["h2"] = float(np.abs(h2).max())
        z = self.w1.project_golden(*self._q_dyn_np(h2))
        obs["mlp"] = float(np.abs(_gelu_np(z)).max())
        return {k: max(v / 127.0, 1e-12) for k, v in obs.items()}

    def forward_golden(self, x: np.ndarray, causal: bool = False
                       ) -> np.ndarray:
        """Numpy reference, dynamic activation scales: [T, d_model] ->
        [T, d_model]."""
        T, D = x.shape
        H = self.n_heads
        dh = D // H

        def proj(p: SparseProjection, v):
            q, s = self._q_dyn_np(v)
            return p.project_golden(q, s)

        h = layer_norm_np(x, self.ln1_g, self.ln1_b)
        qh = proj(self.wq, h).reshape(T, H, dh).transpose(1, 0, 2)
        kh = proj(self.wk, h).reshape(T, H, dh).transpose(1, 0, 2)
        vh = proj(self.wv, h).reshape(T, H, dh).transpose(1, 0, 2)
        logits = np.einsum("htd,hsd->hts", qh, kh) / np.sqrt(
            np.float32(dh))
        if causal:
            mask = np.tril(np.ones((T, T), bool))
            logits = np.where(mask[None], logits, -np.inf)
        e = np.exp(logits - logits.max(axis=-1, keepdims=True))
        attn = e / e.sum(axis=-1, keepdims=True)
        ctx = np.einsum("hts,hsd->htd", attn, vh)
        ctx = ctx.transpose(1, 0, 2).reshape(T, D)
        x = x + proj(self.wo, ctx)

        h = layer_norm_np(x, self.ln2_g, self.ln2_b)
        return x + proj(self.w2, _gelu_np(proj(self.w1, h)))


class TransformerBlockInt8Module(nn.Module):
    """A :class:`TransformerBlockInt8` on ``device``.

    ``scales`` arguments are one block's static scales, at the projection
    inputs ``h1`` (Q, K, V), ``ctx`` (O), ``h2`` (W1) and ``mlp`` (W2): a
    dict of Python floats or of one-element float32 tensors on the device
    (see :meth:`prepare_scales`).  A KV cache is a dict ``k``, ``v``
    ([..., max_len, d_model] float32) and ``len``; unlike the JAX package's,
    it is updated in place.  ``len`` is a Python int (one position for every
    sequence, as ``generate`` and ``generate_speculative`` keep it) or an
    int64 tensor of the leading shape (a position per sequence, as the
    batchers keep it).  Tensor positions past the cache clamp, as the JAX
    package's dynamic slices do: the rows they write are discarded."""

    def __init__(self, block: TransformerBlockInt8, device="cuda"):
        super().__init__()
        self.device = resolve_device(device)
        fp32_matmuls()
        for name in PROJECTIONS:
            setattr(self, name, getattr(block, name).to(self.device))
        for name in ("ln1_g", "ln1_b", "ln2_g", "ln2_b"):
            self.register_buffer(name, torch.from_numpy(np.asarray(
                getattr(block, name), np.float32)).to(self.device))
        self.n_heads = int(block.n_heads)
        self.d_model = block.d_model
        dh = self.d_model // self.n_heads
        self._sqrt_dh = scalar_f32(float(np.sqrt(np.float32(dh))),
                                   self.device)
        self._c127 = scalar_f32(127.0, self.device)

    def prepare_scales(self, scales: Dict) -> Dict[str, torch.Tensor]:
        """Static scales as one-element float32 tensors on the device (each
        Python float rounded once to float32)."""
        return {tap: s if isinstance(s, torch.Tensor)
                else scalar_f32(float(s), self.device)
                for tap, s in scales.items()}

    # ----------------------------------------------------------- helpers
    def init_cache(self, max_len: int, lead=()) -> Dict:
        """Empty KV cache for ``max_len`` positions (leading dims
        ``lead``)."""
        shape = (*lead, max_len, self.d_model)
        return {"k": torch.zeros(shape, device=self.device),
                "v": torch.zeros(shape, device=self.device), "len": 0}

    @staticmethod
    def _ln(v, gamma, beta, rows: bool = False):
        """LayerNorm over the last axis; with ``rows``, its mean and
        variance summed in float64 and rounded once to float32."""
        if not rows:
            mu = v.mean(dim=-1, keepdim=True)
            var = v.var(dim=-1, keepdim=True, correction=0)
            return (v - mu) * torch.rsqrt(var + LN_EPS) * gamma + beta
        v64 = v.to(torch.float64)
        mu = v64.mean(dim=-1, keepdim=True)
        var = (v64 - mu).square().mean(dim=-1, keepdim=True)
        return ((v - mu.to(torch.float32))
                * torch.rsqrt(var.to(torch.float32) + LN_EPS) * gamma + beta)

    @staticmethod
    def _quant(v, s):
        return torch.round(v / s).clamp(-128, 127).to(torch.int8)

    def _q_dyn(self, v):
        """Dynamic per-sequence int8 quantization: scale max|v| / 127 in
        float32 with a 1e-12 floor, shaped [..., 1, 1]."""
        amax = v.abs().amax(dim=(-2, -1), keepdim=True)
        s = torch.clamp_min(amax / self._c127, 1e-12)
        return self._quant(v, s), s

    def _quant_tap(self, v, scales, tap):
        """int8 ``v`` and its scale: the static scale ``tap`` when
        ``scales`` is given, else the dynamic one."""
        if scales is not None:
            return self._quant(v, scales[tap]), scales[tap]
        return self._q_dyn(v)

    def _proj_tap(self, p: PackedProjection, v, scales, tap):
        return p.project(*self._quant_tap(v, scales, tap))

    def _mlp(self, x, scales, rows: bool = False):
        h = self._ln(x, self.ln2_g, self.ln2_b, rows)
        m = F.gelu(self._proj_tap(self.w1, h, scales, "h2"),
                   approximate="tanh")
        return x + self._proj_tap(self.w2, m, scales, "mlp")

    def _heads(self, t):
        """[..., T, d_model] -> [..., H, T, dh]."""
        *lead, T, D = t.shape
        return t.reshape(*lead, T, self.n_heads,
                         D // self.n_heads).transpose(-3, -2)

    def _attend(self, q, k, v, mask=None, rows: bool = False):
        """softmax(q k^T / sqrt(dh)) v over heads [..., H, S, dh] against
        [..., H, L, dh] -> [..., H, S, dh]; with ``rows``, in float64 and
        rounded once to float32.  ``mask`` [..., S, L]: the positions each
        row may attend."""
        if not rows:
            logits = torch.matmul(q, k.transpose(-1, -2)) / self._sqrt_dh
            if mask is not None:
                logits = logits.masked_fill(~mask.unsqueeze(-3),
                                            float("-inf"))
            return torch.matmul(torch.softmax(logits, dim=-1), v)
        f64 = torch.float64
        logits = torch.matmul(q.to(f64), k.to(f64).transpose(-1, -2)) \
            / self._sqrt_dh
        if mask is not None:
            logits = logits.masked_fill(~mask.unsqueeze(-3), float("-inf"))
        return torch.matmul(torch.softmax(logits, dim=-1),
                            v.to(f64)).to(torch.float32)

    def _write(self, cache: Dict, k, v) -> None:
        """Write the K and V rows [..., S, d_model] at ``cache["len"]``:
        a slice where it is an int, each sequence's own rows where it is a
        tensor."""
        pos = cache["len"]
        S, L = k.shape[-2], cache["k"].shape[-2]
        if isinstance(pos, int):
            if pos + S > L:
                raise ValueError(f"KV cache full: positions {pos}.."
                                 f"{pos + S - 1} exceed max_len {L}")
            cache["k"][..., pos:pos + S, :] = k
            cache["v"][..., pos:pos + S, :] = v
            return
        rows = (pos[..., None] + torch.arange(S, device=pos.device)).clamp(
            max=L - 1).reshape(-1, S)
        seq = torch.arange(rows.shape[0], device=rows.device)[:, None]
        for name, t in (("k", k), ("v", v)):
            c = cache[name]
            c.view(-1, L, c.shape[-1])[seq, rows] = t.reshape(
                -1, S, t.shape[-1])

    # ------------------------------------------------- KV-cache decoding
    def qkv_project(self, x_t: torch.Tensor, scales: Optional[Dict],
                    rows: bool = False):
        """LN1 and the Q, K, V projections, row-wise: [..., S, d_model] ->
        three [..., S, d_model] (dynamic scales when ``scales`` is None;
        ``rows``: the decode path's float64 LN statistics).  The three
        share one quantization of the LN output, as they share its
        scale."""
        if scales is not None:
            scales = self.prepare_scales(scales)
        h = self._ln(x_t, self.ln1_g, self.ln1_b, rows)
        hq, s = self._quant_tap(h, scales, "h1")
        return tuple(p.project(hq, s) for p in (self.wq, self.wk, self.wv))

    def attend_mlp_multi(self, x_s, q_s, k_all, v_all, pos,
                         scales: Dict) -> torch.Tensor:
        """Causal attention of S rows [..., S, d_model] over a K/V view
        [..., L, d_model] (row i masks the positions past ``pos + i``;
        positions pos..pos+S-1 hold the rows' own K/V), the output
        projection and the MLP.  ``pos`` is an int or a tensor of the lead
        shape: a contiguous cache, or the paged engine's gathered view."""
        scales = self.prepare_scales(scales)
        S, L = x_s.shape[-2], k_all.shape[-2]
        cols = torch.arange(L, device=self.device)
        if isinstance(pos, int):
            mask = cols <= (pos + torch.arange(S, device=self.device))[:, None]
        else:
            mask = cols <= (pos[..., None]
                            + torch.arange(S, device=self.device))[..., None]
        ctx = self._attend(self._heads(q_s), self._heads(k_all),
                           self._heads(v_all), mask, rows=True)
        ctx = ctx.transpose(-3, -2).reshape(x_s.shape)
        x_s = x_s + self._proj_tap(self.wo, ctx, scales, "ctx")
        return self._mlp(x_s, scales, rows=True)

    def decode_step(self, cache: Dict, x_t: torch.Tensor, scales: Dict):
        """One-token causal decode through the cache: x_t [..., 1,
        d_model] -> (y_t [..., 1, d_model], the cache with this token's K/V
        written at position ``len`` and ``len`` advanced by one).  The S = 1
        case of :meth:`verify_step`, so that a decode step and a row of a
        verify pass are one computation."""
        return self.verify_step(cache, x_t, scales)

    def verify_step(self, cache: Dict, x_s: torch.Tensor, scales: Dict):
        """S tokens [..., S, d_model] at positions len..len+S-1, attending
        the cache and each other causally: the verify pass of speculative
        decoding, one batched product per projection where S decode steps
        would issue S.  Returns (y [..., S, d_model], the cache with ``len``
        advanced by S); a caller that rejects drafts rolls ``len`` back, and
        the stale rows above it are masked by position and overwritten by
        the next write."""
        scales = self.prepare_scales(scales)
        q, k, v = self.qkv_project(x_s, scales, rows=True)
        self._write(cache, k, v)
        pos = cache["len"]
        cache = {"k": cache["k"], "v": cache["v"],
                 "len": pos + x_s.shape[-2]}
        return self.attend_mlp_multi(x_s, q, cache["k"], cache["v"], pos,
                                     scales), cache

    # ------------------------------------------------------ full forward
    def forward(self, x: torch.Tensor, causal: bool = False,
                scales: Optional[Dict] = None, flash: bool = False,
                plain: bool = False, rows: bool = False) -> torch.Tensor:
        """[..., T, d_model] float32 -> [..., T, d_model].  ``flash`` routes
        attention through K5 (``plain`` through its plain version);
        ``rows``: the decode path's float64 reductions."""
        return self._forward_kv(x, causal, scales, flash, plain, rows)[0]

    def prefill(self, x: torch.Tensor, scales: Dict, cache: Dict,
                flash: bool = False, plain: bool = False):
        """Parallel KV-cache fill: one causal forward over the prompt
        [..., T, d_model] that also writes each position's K/V into the
        cache.  Returns (y, the cache with ``len`` = T)."""
        T = x.shape[-2]
        y, k_flat, v_flat = self._forward_kv(x, True, scales, flash, plain)
        cache["k"][..., :T, :] = k_flat
        cache["v"][..., :T, :] = v_flat
        return y, {"k": cache["k"], "v": cache["v"], "len": T}

    def _forward_kv(self, x, causal, scales, flash, plain=False,
                    rows=False):
        """Shared body: returns (y, k_flat, v_flat), each [..., T, D]."""
        if scales is not None:
            scales = self.prepare_scales(scales)
        q, k_flat, v_flat = self.qkv_project(x, scales, rows)
        qh, kh, vh = self._heads(q), self._heads(k_flat), self._heads(v_flat)
        T = x.shape[-2]
        if flash:
            attention = flash_attention_plain if plain else flash_attention
            dh = qh.shape[-1]
            ctx = attention(*(t.reshape(-1, T, dh).contiguous()
                              for t in (qh, kh, vh)),
                            causal=causal).reshape(qh.shape)
        else:
            mask = (torch.ones((T, T), dtype=torch.bool,
                               device=self.device).tril()
                    if causal else None)
            ctx = self._attend(qh, kh, vh, mask, rows)
        ctx = ctx.transpose(-3, -2).reshape(x.shape)
        x = x + self._proj_tap(self.wo, ctx, scales, "ctx")
        return self._mlp(x, scales, rows), k_flat, v_flat
