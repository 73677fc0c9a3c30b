"""INT8 block-sparse decoder language model, in PyTorch.

Counterpart of ``resnet_accel_tpu/models/lm.py``::

    tokens -> embed + sinusoidal pos -> [block x N, causal] -> LN_f
           -> x @ embed^T (tied readout)

- ``TransformerLMInt8`` holds the model as numpy data: the seeded
  ``from_random`` (the same numbers as the JAX package's), ``calibrate``
  (per-block static activation scales through the numpy golden, bit for bit
  the JAX package's), ``forward_golden``, ``.npz`` I/O and
  :func:`from_reference`.  ``generate`` runs greedy generation on a device
  (the card unless the caller asks for the CPU).
- ``TransformerLMInt8Module`` is the model on a device: the teacher-forced
  causal ``forward``, the KV-cache ``prefill`` (one causal forward per
  block; kernel K5 with ``flash=True``), ``decode_step`` and ``generate``.
  The decode loop is a Python loop over tokens.  ``batched=True`` takes
  [B, T] prompts; each row equals its own single-prompt run.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn

from resnet_accel_tpu_torch.models.attention import SparseProjection
from resnet_accel_tpu_torch.models.transformer import (
    PROJECTIONS,
    TransformerBlockInt8,
    TransformerBlockInt8Module,
    layer_norm_np,
)
from resnet_accel_tpu_torch.ops.flash_attention import fp32_matmuls
from resnet_accel_tpu_torch.runtime.backend import resolve_device
from resnet_accel_tpu_torch.sparse.bsr import BSRMatrix

#: Static activation scales, one dict per block (keys h1, ctx, h2, mlp).
Scales = List[Dict[str, float]]

_LN = ("ln1_g", "ln1_b", "ln2_g", "ln2_b")
_BSR_ARRAYS = ("data", "row_ptr", "col_idx")


def sinusoidal_positions(max_len: int, d_model: int) -> np.ndarray:
    """Standard fixed sinusoidal position table [max_len, d_model]."""
    pos = np.arange(max_len, dtype=np.float32)[:, None]
    dim = np.arange(0, d_model, 2, dtype=np.float32)[None, :]
    ang = pos / np.power(10000.0, dim / np.float32(d_model))
    pe = np.zeros((max_len, d_model), np.float32)
    pe[:, 0::2] = np.sin(ang)
    pe[:, 1::2] = np.cos(ang)
    return pe


@dataclasses.dataclass
class TransformerLMInt8:
    """Decoder-only LM over INT8 block-sparse transformer blocks (numpy)."""

    embed: np.ndarray                  # [vocab, d_model] float32
    pos: np.ndarray                    # [max_len, d_model] float32
    blocks: List[TransformerBlockInt8]
    lnf_g: np.ndarray
    lnf_b: np.ndarray
    _on_device: Dict[str, "TransformerLMInt8Module"] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @classmethod
    def from_random(
        cls,
        vocab: int = 64,
        d_model: int = 128,
        n_heads: int = 4,
        d_ff: int = 256,
        n_layers: int = 2,
        max_len: int = 64,
        sparsity: float = 0.8,
        block: int = 8,
        seed: int = 0,
    ) -> "TransformerLMInt8":
        rng = np.random.default_rng(seed)
        emb = rng.normal(0, 0.5, (vocab, d_model)).astype(np.float32)
        blocks = [
            TransformerBlockInt8.from_random(
                d_model=d_model, n_heads=n_heads, d_ff=d_ff,
                sparsity=sparsity, block=block, seed=seed + 100 * (i + 1))
            for i in range(n_layers)
        ]
        return cls(embed=emb, pos=sinusoidal_positions(max_len, d_model),
                   blocks=blocks, lnf_g=np.ones(d_model, np.float32),
                   lnf_b=np.zeros(d_model, np.float32))

    @property
    def d_model(self) -> int:
        return self.embed.shape[1]

    @property
    def vocab(self) -> int:
        return self.embed.shape[0]

    @property
    def max_len(self) -> int:
        return self.pos.shape[0]

    def calibrate(self, tokens: np.ndarray) -> Scales:
        """Per-block static activation scales from one calibration sequence
        (golden numpy propagation, causal)."""
        x = self.embed[np.asarray(tokens)] + self.pos[: len(tokens)]
        scales: Scales = []
        for blk in self.blocks:
            scales.append(blk.calibrate_scales(x))
            x = blk.forward_golden(x, causal=True)
        return scales

    def forward_golden(self, tokens: np.ndarray) -> np.ndarray:
        """Numpy reference (dynamic activation scales): [T] -> [T, V]."""
        x = self.embed[np.asarray(tokens)] + self.pos[: len(tokens)]
        for blk in self.blocks:
            x = blk.forward_golden(x, causal=True)
        return layer_norm_np(x, self.lnf_g, self.lnf_b) @ self.embed.T

    def module(self, device="cuda") -> "TransformerLMInt8Module":
        """The model on ``device``, built once per device."""
        dev = resolve_device(device)
        if str(dev) not in self._on_device:
            self._on_device[str(dev)] = TransformerLMInt8Module(self, dev)
        return self._on_device[str(dev)]

    def generate(self, prompt, n_new: int, scales: Scales, *,
                 parallel_prefill: bool = True, flash: bool = False,
                 batched: bool = False, device="cuda") -> np.ndarray:
        """Greedy generation on ``device``: see
        :meth:`TransformerLMInt8Module.generate`."""
        return self.module(device).generate(
            prompt, n_new, scales, parallel_prefill=parallel_prefill,
            flash=flash, batched=batched)

    # -------------------------------------------------------------- npz
    def save_npz(self, path: str) -> None:
        arrays = {"embed": self.embed, "pos": self.pos,
                  "lnf_g": self.lnf_g, "lnf_b": self.lnf_b}
        for i, blk in enumerate(self.blocks):
            arrays[f"b{i}.n_heads"] = np.array(blk.n_heads)
            for k in _LN:
                arrays[f"b{i}.{k}"] = getattr(blk, k)
            for name in PROJECTIONS:
                p = getattr(blk, name)
                prefix = f"b{i}.{name}"
                for k in _BSR_ARRAYS:
                    arrays[f"{prefix}.{k}"] = getattr(p.bsr, k)
                arrays[f"{prefix}.geom"] = np.array(
                    [*p.bsr.shape, p.bsr.block_h, p.bsr.block_w])
                arrays[f"{prefix}.scales"] = p.scales
                if p.bias is not None:
                    arrays[f"{prefix}.bias"] = p.bias
        np.savez(path, **arrays)

    @classmethod
    def load_npz(cls, path: str) -> "TransformerLMInt8":
        with np.load(path, allow_pickle=False) as z:
            def proj(prefix):
                h, w, bh, bw = (int(v) for v in z[f"{prefix}.geom"])
                bsr = BSRMatrix(**{k: z[f"{prefix}.{k}"]
                                   for k in _BSR_ARRAYS},
                                shape=(h, w), block_h=bh, block_w=bw)
                bias = (z[f"{prefix}.bias"] if f"{prefix}.bias" in z.files
                        else None)
                return SparseProjection(bsr=bsr, scales=z[f"{prefix}.scales"],
                                        bias=bias)

            n_layers = sum(1 for k in z.files if k.endswith(".n_heads"))
            blocks = [TransformerBlockInt8(
                **{name: proj(f"b{i}.{name}") for name in PROJECTIONS},
                **{k: z[f"b{i}.{k}"] for k in _LN},
                n_heads=int(z[f"b{i}.n_heads"])) for i in range(n_layers)]
            return cls(embed=z["embed"], pos=z["pos"], blocks=blocks,
                       lnf_g=z["lnf_g"], lnf_b=z["lnf_b"])


def from_reference(lm) -> TransformerLMInt8:
    """Carry the JAX package's ``TransformerLMInt8`` across: its numpy
    arrays (embeddings, positions, LayerNorm parameters, and each
    projection's BSR ``data``, ``row_ptr``, ``col_idx``, ``scales`` and
    ``bias``) and each block's ``n_heads``; nothing of the JAX module is
    imported."""
    def proj(p) -> SparseProjection:
        b = p.bsr
        bsr = BSRMatrix(data=np.asarray(b.data, np.int8),
                        row_ptr=np.asarray(b.row_ptr, np.int32),
                        col_idx=np.asarray(b.col_idx, np.int32),
                        shape=tuple(int(s) for s in b.shape),
                        block_h=int(b.block_h), block_w=int(b.block_w))
        return SparseProjection(
            bsr=bsr, scales=np.asarray(p.scales, np.float32),
            bias=None if p.bias is None else np.asarray(p.bias, np.float32))

    blocks = [TransformerBlockInt8(
        **{name: proj(getattr(blk, name)) for name in PROJECTIONS},
        **{k: np.asarray(getattr(blk, k), np.float32) for k in _LN},
        n_heads=int(blk.n_heads)) for blk in lm.blocks]
    return TransformerLMInt8(
        embed=np.asarray(lm.embed, np.float32),
        pos=np.asarray(lm.pos, np.float32), blocks=blocks,
        lnf_g=np.asarray(lm.lnf_g, np.float32),
        lnf_b=np.asarray(lm.lnf_b, np.float32))


class TransformerLMInt8Module(nn.Module):
    """A :class:`TransformerLMInt8` on ``device``.  Token inputs are
    integer arrays or tensors, [T] or, with leading batch dimensions,
    [B, T]; ``scales`` is the list :meth:`TransformerLMInt8.calibrate`
    returns.  ``plain=True`` runs the plain version of every kernel in
    place of the kernel (the CPU always does)."""

    def __init__(self, model: TransformerLMInt8, device="cuda"):
        super().__init__()
        self.device = resolve_device(device)
        fp32_matmuls()
        for name in ("embed", "pos", "lnf_g", "lnf_b"):
            self.register_buffer(name, torch.from_numpy(np.asarray(
                getattr(model, name), np.float32)).to(self.device))
        self.blocks = nn.ModuleList(
            TransformerBlockInt8Module(b, self.device) for b in model.blocks)
        self.max_len = model.max_len
        self.vocab = model.vocab

    def prepare_scales(self, scales: Scales) -> List[Dict[str, torch.Tensor]]:
        return [blk.prepare_scales(s) for blk, s in zip(self.blocks, scales)]

    def _tokens(self, tokens) -> torch.Tensor:
        if isinstance(tokens, torch.Tensor):
            return tokens.to(device=self.device, dtype=torch.long)
        return torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                               device=self.device)

    def _ln_f(self, x):
        return TransformerBlockInt8Module._ln(x, self.lnf_g, self.lnf_b)

    def _logits(self, x):
        return torch.matmul(self._ln_f(x), self.embed.T)

    @torch.inference_mode()
    def forward(self, tokens, scales: Optional[Scales] = None,
                flash: bool = False, plain: bool = False) -> torch.Tensor:
        """Teacher-forced causal pass: tokens [..., T] -> logits
        [..., T, V] (dynamic activation scales when ``scales`` is None)."""
        tokens = self._tokens(tokens)
        T = tokens.shape[-1]
        x = self.embed[tokens] + self.pos[:T]
        for i, blk in enumerate(self.blocks):
            x = blk(x, causal=True,
                    scales=None if scales is None else scales[i],
                    flash=flash, plain=plain)
        return self._logits(x)

    def init_caches(self, max_len: Optional[int] = None, lead=()):
        n = self.max_len if max_len is None else max_len
        return [blk.init_cache(n, lead) for blk in self.blocks]

    @torch.inference_mode()
    def decode_step(self, caches, tok, scales: Scales):
        """One token (a scalar, or [B] tokens) through all blocks at
        position ``len``: returns (logits [V] or [B, V], the caches)."""
        tok = self._tokens(tok)
        pos = caches[0]["len"]
        if pos >= self.max_len:
            raise ValueError(f"position {pos} exceeds max_len "
                             f"({self.max_len})")
        x = (self.embed[tok] + self.pos[pos]).unsqueeze(-2)
        new_caches = []
        for blk, cache, s in zip(self.blocks, caches, scales):
            x, c = blk.decode_step(cache, x, s)
            new_caches.append(c)
        return self._logits(x)[..., 0, :], new_caches

    @torch.inference_mode()
    def prefill(self, tokens, scales: Scales, flash: bool = False,
                plain: bool = False):
        """Fill fresh caches from the prompt [..., T] with one causal
        forward per block; returns (the last row's logits [..., V], the
        caches with ``len`` = T)."""
        tokens = self._tokens(tokens)
        T = tokens.shape[-1]
        x = self.embed[tokens] + self.pos[:T]
        caches = []
        for blk, s in zip(self.blocks, scales):
            x, c = blk.prefill(x, s, blk.init_cache(self.max_len,
                                                    tokens.shape[:-1]),
                               flash=flash, plain=plain)
            caches.append(c)
        return self._logits(x[..., -1:, :])[..., 0, :], caches

    @torch.inference_mode()
    def generate(self, prompt, n_new: int, scales: Scales, *,
                 parallel_prefill: bool = True, flash: bool = False,
                 batched: bool = False, plain: bool = False) -> np.ndarray:
        """Greedy decoding: the prompt's KV caches, then ``n_new`` argmax
        tokens, as int32 [n_new] (or [B, n_new] for ``batched`` [B, T]
        prompts).  ``parallel_prefill`` fills the caches with one causal
        forward per block (through K5 with ``flash``); without it, with one
        ``decode_step`` per prompt token."""
        prompt = np.asarray(prompt)
        if prompt.ndim != (2 if batched else 1):
            raise ValueError(f"prompt of shape {prompt.shape}: expected "
                             f"{'[B, T]' if batched else '[T]'}")
        n_prompt = prompt.shape[-1]
        if n_prompt + n_new > self.max_len:
            raise ValueError(
                f"prompt ({n_prompt}) + n_new ({n_new}) exceeds max_len "
                f"({self.max_len}); cache and position writes would run "
                f"past the end")
        scales = self.prepare_scales(scales)
        if n_new == 0:
            return np.zeros(prompt.shape[:-1] + (0,), np.int32)
        toks = self._tokens(prompt)
        if parallel_prefill:
            last, caches = self.prefill(toks, scales, flash=flash,
                                        plain=plain)
        else:
            caches = self.init_caches(lead=toks.shape[:-1])
            for t in range(n_prompt):
                last, caches = self.decode_step(caches, toks[..., t], scales)
        tok = last.argmax(dim=-1)
        out = [tok]
        for _ in range(n_new - 1):
            logits, caches = self.decode_step(caches, tok, scales)
            tok = logits.argmax(dim=-1)
            out.append(tok)
        return torch.stack(out, dim=-1).cpu().numpy().astype(np.int32)
