"""INT8 block-sparse decoder language model, in PyTorch.

Counterpart of ``resnet_accel_tpu/models/lm.py``::

    tokens -> embed + sinusoidal pos -> [block x N, causal] -> LN_f
           -> x @ embed^T (tied readout)

- ``TransformerLMInt8`` holds the model as numpy data: the seeded
  ``from_random`` (the same numbers as the JAX package's), ``calibrate``
  (per-block static activation scales through the numpy golden, bit for bit
  the JAX package's), ``forward_golden``, ``.npz`` I/O and
  :func:`from_reference`.  ``generate``, ``sample`` and
  ``generate_speculative`` run on a device (the card unless the caller asks
  for the CPU).
- ``TransformerLMInt8Module`` is the model on a device: the teacher-forced
  causal ``forward``, the KV-cache ``prefill`` (one causal forward per
  block; kernel K5 with ``flash=True``), ``decode_step``, the S-token
  ``verify_step``, greedy ``generate``, temperature and top-k ``sample``
  and prompt-lookup ``generate_speculative``, greedy or sampled.  The
  decode loops are Python loops over tokens or verify passes.
  ``batched=True`` takes [B, T] prompts; each row equals its own
  single-prompt run.

The samplers and their random keys are ``models/sampling.py``'s; a key is
``prng_key(seed)``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn

from resnet_accel_tpu_torch.models.attention import (
    SparseProjection, projection_from_reference)
from resnet_accel_tpu_torch.models.sampling import (  # noqa: F401
    adjust_logits,
    greedy_accept,
    prng_key,
    sampled_token,
    spec_accept_sampled,
)
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

    def __getstate__(self):
        """Pickled as its numpy data (to a spawned rank, say): the modules
        built on devices stay behind."""
        return {**self.__dict__, "_on_device": {}}

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

    def sample(self, prompt, n_new: int, scales: Scales, rng_key, *,
               temperature: float = 1.0, top_k: Optional[int] = None,
               flash: bool = False, device="cuda") -> np.ndarray:
        """Temperature and top-k sampling on ``device``: see
        :meth:`TransformerLMInt8Module.sample`."""
        return self.module(device).sample(
            prompt, n_new, scales, rng_key, temperature=temperature,
            top_k=top_k, flash=flash)

    def generate_speculative(self, prompt, n_new: int, scales: Scales, *,
                             device="cuda", **kw):
        """Speculative decoding on ``device``: see
        :meth:`TransformerLMInt8Module.generate_speculative`."""
        return self.module(device).generate_speculative(prompt, n_new,
                                                        scales, **kw)

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
    blocks = [TransformerBlockInt8(
        **{name: projection_from_reference(getattr(blk, name))
           for name in PROJECTIONS},
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
        self.register_buffer("embed64", self.embed.to(torch.float64))
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

    def _logits(self, x, rows: bool = False):
        """The final LayerNorm and the tied readout; with ``rows`` (the
        decode path), summed in float64 and rounded once to float32 (see
        ``models/transformer.py``: a row's logits do not depend on how many
        rows go with it)."""
        if not rows:
            return torch.matmul(self._ln_f(x), self.embed.T)
        h = TransformerBlockInt8Module._ln(x, self.lnf_g, self.lnf_b, True)
        return torch.matmul(h.to(torch.float64),
                            self.embed64.T).to(torch.float32)

    def _embed_at(self, tok, pos, S: int = 1):
        """Token and position embeddings of S tokens [..., S] at positions
        pos..pos+S-1: ``pos`` an int, or a tensor of the lead shape whose
        positions past the table clamp to its last row (their outputs are
        discarded, as with the JAX package's clamped slices)."""
        if isinstance(pos, int):
            if pos + S > self.max_len:
                raise ValueError(f"position {pos + S - 1} exceeds max_len "
                                 f"({self.max_len})")
            return self.embed[tok] + self.pos[pos:pos + S]
        rows = pos[..., None] + torch.arange(S, device=self.device)
        return self.embed[tok] + self.pos[rows.clamp(max=self.max_len - 1)]

    @torch.inference_mode()
    def forward(self, tokens, scales: Optional[Scales] = None,
                flash: bool = False, plain: bool = False) -> torch.Tensor:
        """Teacher-forced causal pass: tokens [..., T] -> logits
        [..., T, V] (dynamic activation scales when ``scales`` is None),
        with the decode path's float64 reductions, so that each row is what
        a decode step at its position gives (the paged engine's ``score()``
        is held to it)."""
        tokens = self._tokens(tokens)
        T = tokens.shape[-1]
        x = self.embed[tokens] + self.pos[:T]
        for i, blk in enumerate(self.blocks):
            x = blk(x, causal=True,
                    scales=None if scales is None else scales[i],
                    flash=flash, plain=plain, rows=True)
        return self._logits(x, rows=True)

    def init_caches(self, max_len: Optional[int] = None, lead=()):
        n = self.max_len if max_len is None else max_len
        return [blk.init_cache(n, lead) for blk in self.blocks]

    @torch.inference_mode()
    def decode_step(self, caches, tok, scales: Scales):
        """One token (a scalar, or [B] tokens) through all blocks at
        position ``len`` (an int, or a tensor of the lead shape): returns
        (logits [V] or [B, V], the caches)."""
        logits, caches = self.verify_step(caches, self._tokens(tok)[..., None],
                                          scales)
        return logits[..., 0, :], caches

    @torch.inference_mode()
    def verify_step(self, caches, toks, scales: Scales):
        """S tokens [..., S] through all blocks at positions len..len+S-1,
        the speculative verify pass: returns (logits [..., S, V], the caches
        with ``len`` advanced by S)."""
        toks = self._tokens(toks)
        x = self._embed_at(toks, caches[0]["len"], toks.shape[-1])
        new_caches = []
        for blk, cache, s in zip(self.blocks, caches, scales):
            x, c = blk.verify_step(cache, x, s)
            new_caches.append(c)
        return self._logits(x, rows=True), new_caches

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

    def _key(self, rng_key) -> torch.Tensor:
        """A key of ``models/sampling.py`` on this device."""
        return torch.as_tensor(rng_key, dtype=torch.int64,
                               device=self.device)

    @torch.inference_mode()
    def sample(self, prompt, n_new: int, scales: Scales, rng_key, *,
               temperature: float = 1.0, top_k: Optional[int] = None,
               flash: bool = False) -> np.ndarray:
        """Stochastic decoding with temperature and optional top-k
        truncation, int32 [n_new] for a prompt [T]: the parallel prefill
        (through K5 with ``flash``), then one draw a token, each splitting
        the key once (``sampled_token``).  ``temperature <= 0`` is greedy
        and equals ``generate``.  Deterministic for a fixed ``rng_key``
        (``prng_key(seed)``)."""
        prompt = np.asarray(prompt)
        n_prompt = prompt.shape[-1]
        if n_prompt + n_new > self.max_len:
            raise ValueError(f"prompt ({n_prompt}) + n_new ({n_new}) exceeds "
                             f"max_len ({self.max_len})")
        if top_k is not None and top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        if n_new == 0:
            return np.zeros(0, np.int32)
        scales = self.prepare_scales(scales)
        key = self._key(rng_key)

        def draw(logits):
            nonlocal key
            if temperature <= 0.0:
                return logits.argmax(dim=-1)
            key, tok = sampled_token(logits, key, temperature, top_k)
            return tok

        logits, caches = self.prefill(prompt, scales, flash=flash)
        out = [draw(logits)]
        for _ in range(n_new - 1):
            logits, caches = self.decode_step(caches, out[-1], scales)
            out.append(draw(logits))
        return torch.stack(out).cpu().numpy().astype(np.int32)

    @staticmethod
    def _lookup(ctx: np.ndarray, t: int, ngram: int, n: int) -> np.ndarray:
        """Prompt-lookup drafts, as the JAX package's: the ``n`` tokens of
        ``ctx`` after the most recent strictly earlier occurrence of its
        last ``ngram`` known tokens (``ctx[:t]``), else the newest token
        repeated."""
        if t > ngram:
            wins = np.lib.stride_tricks.sliding_window_view(
                ctx[:t - 1], ngram)               # windows 0 .. t-ngram-1
            hits = np.flatnonzero((wins == ctx[t - ngram:t]).all(axis=1))
            if hits.size:
                p = int(hits[-1]) + ngram
                return ctx[p:p + n]
        return np.full(n, ctx[t - 1], ctx.dtype)

    @torch.inference_mode()
    def generate_speculative(self, prompt, n_new: int, scales: Scales, *,
                             draft: int = 15, ngram: int = 3,
                             flash: bool = False, return_stats: bool = False,
                             temperature: float = 0.0,
                             top_k: Optional[int] = None, rng_key=None):
        """Speculative decoding with prompt-lookup drafts, int32 [n_new] for
        a prompt [T] (with ``return_stats``: and the verify passes run).

        The prefill is ``generate``'s (through K5 with ``flash``).  Each
        pass then verifies the newest token and ``draft`` drafts in one
        ``verify_step`` and keeps the accepted ones.  ``temperature <= 0``:
        greedy, a draft survives while it equals the model's argmax chain,
        so the tokens equal ``generate``'s.  ``temperature > 0``:
        ``spec_accept_sampled`` (needs ``rng_key``), every token distributed
        as ``sample``'s draws.  Drafts continue the most recent earlier
        occurrence of the last ``ngram`` tokens.  The tokens never pass
        ``n_new``, and after each pass the caches' ``len`` rolls back to
        the tokens consumed.  Each pass reads its accepted count and tokens
        to the host once.  Needs prompt + n_new + draft <= max_len: a pass
        writes ``draft + 1`` K/V rows past the accepted length."""
        S = draft + 1
        prompt = np.asarray(prompt)
        n_prompt = prompt.shape[-1]
        if n_prompt + n_new + draft > self.max_len:
            raise ValueError(
                f"prompt ({n_prompt}) + n_new ({n_new}) + draft ({draft}) "
                f"exceeds max_len ({self.max_len}); shrink draft or the "
                "request")
        if ngram < 1:
            raise ValueError("ngram must be >= 1")
        if top_k is not None and top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        greedy = temperature <= 0.0
        if not greedy and rng_key is None:
            raise ValueError("temperature > 0 requires rng_key (speculative "
                             "sampling is stochastic)")
        scales = self.prepare_scales(scales)
        last, caches = self.prefill(prompt, scales, flash=flash)
        if greedy:
            tok0 = last.argmax(dim=-1)
        else:
            key, tok0 = sampled_token(last, self._key(rng_key), temperature,
                                      top_k)
        # ctx holds the prompt, then the emitted tokens and, past t, the
        # last pass's unaccepted overhang, as the JAX package's buffer does
        # (its drafts may read it).  t = tokens known; the caches hold
        # t - 1 of them (the newest enters with the next pass).
        ctx = np.zeros(self.max_len, np.int64)
        ctx[:n_prompt] = prompt
        ctx[n_prompt] = int(tok0)
        t, n_out, steps = n_prompt + 1, 1, 0
        while n_out < n_new:
            fed = torch.as_tensor(np.concatenate(
                [ctx[t - 1:t], self._lookup(ctx, t, ngram, S - 1)]),
                device=self.device)
            logits, caches = self.verify_step(caches, fed, scales)
            if greedy:
                n_acc, emit = greedy_accept(logits, fed)
            else:
                n_acc, emit, key = spec_accept_sampled(
                    adjust_logits(logits, temperature, top_k), fed, key)
            host = torch.cat([n_acc.view(1), emit]).cpu().numpy()
            n_acc = min(int(host[0]), n_new - 1 - n_out)
            ctx[t:t + S] = host[1:]
            t += n_acc + 1
            n_out += n_acc + 1
            caches = [dict(c, len=t - 1) for c in caches]
            steps += 1
        toks = ctx[n_prompt:n_prompt + n_new].astype(np.int32)
        return (toks, steps) if return_stats else toks
