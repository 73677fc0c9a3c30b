"""Decoder-LM training pipeline: train -> block-prune -> INT8 -> serve.

Counterpart of ``resnet_accel_tpu/train/lm.py``: an fp32 trainer whose
architecture mirrors ``models.lm.TransformerLMInt8`` (pre-LN blocks,
sinusoidal positions, tied readout), magnitude block pruning of the six
projections of each block, and a quantizer that packs the pruned fp32
weights into the INT8 BSR serving model through the same per-channel
quantization and BSR build as the fixture path.

The synthetic task is the affine cyclic language t_{i+1} = (a*t_i + b)
mod V.  The JAX trainer ``vmap``s its one-sequence forward over the batch;
here ``lm_forward_fp32`` takes a batch of sequences at once.  GELU is the
tanh approximation (``jax.nn.gelu``'s default), products float32 with TF32
off.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from resnet_accel_tpu_torch.models.lm import (TransformerLMInt8,
                                              sinusoidal_positions)
from resnet_accel_tpu_torch.models.transformer import (LN_EPS,
                                                       TransformerBlockInt8,
                                                       _make_projection)
from resnet_accel_tpu_torch.ops.epilogue import scalar_f32
from resnet_accel_tpu_torch.ops.flash_attention import fp32_matmuls
from resnet_accel_tpu_torch.runtime.backend import resolve_device
from resnet_accel_tpu_torch.train.mnist import host_floats, to_device

PROJ_NAMES = ("wq", "wk", "wv", "wo", "w1", "w2")


# ==========================================================================
# FP32 model (architecture-identical to TransformerLMInt8)
# ==========================================================================

def init_lm_fp32(
    vocab: int = 32,
    d_model: int = 64,
    n_heads: int = 4,
    d_ff: int = 128,
    n_layers: int = 1,
    max_len: int = 32,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    p: Dict[str, np.ndarray] = {
        "embed": rng.normal(0, 0.5, (vocab, d_model)).astype(np.float32),
        "pos": sinusoidal_positions(max_len, d_model),
        "lnf_g": np.ones(d_model, np.float32),
        "lnf_b": np.zeros(d_model, np.float32),
        "meta": np.asarray([n_layers, n_heads], np.int32),
    }
    for i in range(n_layers):
        def w(o, inp):
            return rng.normal(0, 1.0 / np.sqrt(inp),
                              (o, inp)).astype(np.float32)

        p[f"b{i}.wq"] = w(d_model, d_model)
        p[f"b{i}.wk"] = w(d_model, d_model)
        p[f"b{i}.wv"] = w(d_model, d_model)
        p[f"b{i}.wo"] = w(d_model, d_model)
        p[f"b{i}.w1"] = w(d_ff, d_model)
        p[f"b{i}.w2"] = w(d_model, d_ff)
        for name, o in (("wq", d_model), ("wk", d_model),
                        ("wv", d_model), ("wo", d_model),
                        ("w1", d_ff), ("w2", d_model)):
            p[f"b{i}.{name}_b"] = np.zeros(o, np.float32)
        p[f"b{i}.ln1_g"] = np.ones(d_model, np.float32)
        p[f"b{i}.ln1_b"] = np.zeros(d_model, np.float32)
        p[f"b{i}.ln2_g"] = np.ones(d_model, np.float32)
        p[f"b{i}.ln2_b"] = np.zeros(d_model, np.float32)
    return p


def _ln(v, g, b):
    var, mu = torch.var_mean(v, dim=-1, keepdim=True, correction=0)
    return (v - mu) * torch.rsqrt(var + LN_EPS) * g + b


def lm_forward_fp32(params, tokens: torch.Tensor,
                    n_layers: int, n_heads: int) -> torch.Tensor:
    """Causal fp32 forward of token sequences [..., T] -> logits
    [..., T, V]; mirrors the INT8 model's dataflow with the quantization
    boundaries removed.  ``params``: tensors by name."""
    T = tokens.shape[-1]
    x = params["embed"][tokens] + params["pos"][:T]
    lead = x.shape[:-2]
    mask = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()

    for i in range(n_layers):
        D = x.shape[-1]
        dh = D // n_heads
        h = _ln(x, params[f"b{i}.ln1_g"], params[f"b{i}.ln1_b"])

        def proj(name, v):
            return v @ params[f"b{i}.{name}"].T + params[f"b{i}.{name}_b"]

        def heads(v):
            return v.reshape(*lead, T, n_heads, dh).transpose(-3, -2)

        qh, kh, vh = heads(proj("wq", h)), heads(proj("wk", h)), \
            heads(proj("wv", h))
        s = (qh @ kh.transpose(-1, -2)) / torch.sqrt(
            scalar_f32(dh, x.device))
        s = s.masked_fill(~mask, float("-inf"))
        ctx = torch.softmax(s, dim=-1) @ vh
        ctx = ctx.transpose(-3, -2).reshape(*lead, T, D)
        x = x + proj("wo", ctx)
        h = _ln(x, params[f"b{i}.ln2_g"], params[f"b{i}.ln2_b"])
        x = x + proj("w2", F.gelu(proj("w1", h), approximate="tanh"))

    x = _ln(x, params["lnf_g"], params["lnf_b"])
    return x @ params["embed"].T


# ==========================================================================
# Synthetic task + trainer
# ==========================================================================

def cyclic_sequences(vocab: int, seq_len: int, n: int, seed: int = 0,
                     a: int = 3, b: int = 1) -> np.ndarray:
    """n sequences of the affine cyclic language t_{i+1}=(a*t_i+b)%V."""
    rng = np.random.default_rng(seed)
    t0 = rng.integers(0, vocab, n)
    seqs = np.empty((n, seq_len), np.int32)
    seqs[:, 0] = t0
    for i in range(1, seq_len):
        seqs[:, i] = (a * seqs[:, i - 1] + b) % vocab
    return seqs


def adam_steps(
    params: Dict[str, np.ndarray],
    n_layers: int,
    n_heads: int,
    next_batch: Callable[[], np.ndarray],
    steps: int,
    lr: float = 3e-3,
    device="cuda",
    masks: Optional[Dict[str, np.ndarray]] = None,
    on_step: Optional[Callable] = None,
) -> Tuple[Dict[str, np.ndarray], List[float]]:
    """``steps`` Adam steps on the mean next-token cross-entropy of the
    token windows that ``next_batch()`` returns, one [batch, seq] array a
    step.  Every parameter but ``meta`` and the sinusoidal ``pos`` table
    trains; each of ``masks`` (by key) is multiplied back into its
    parameter after every step.  ``on_step(step, loss, tensors)`` runs
    after each.  Runs on ``device`` (``"cuda"`` by default; it raises
    without a card).  Returns (params, loss history)."""
    dev = resolve_device(device)
    fp32_matmuls()
    train_keys = [k for k in params if k != "meta" and k != "pos"]
    tp = to_device(params, dev, train_keys)
    full = dict(tp)
    full["pos"] = torch.from_numpy(np.asarray(params["pos"])).to(dev)
    opt = torch.optim.Adam(list(tp.values()), lr=lr)
    tmasks = {k: torch.from_numpy(np.asarray(m, np.float32)).to(dev)
              for k, m in (masks or {}).items()}

    losses = []
    for s in range(steps):
        toks = torch.from_numpy(next_batch()).to(dev).long()
        logits = lm_forward_fp32(full, toks, n_layers, n_heads)
        loss = F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                               toks[:, 1:].reshape(-1))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if tmasks:
            with torch.no_grad():
                for k, m in tmasks.items():
                    tp[k].mul_(m)
        losses.append(loss.detach())
        if on_step is not None:
            on_step(s, losses[-1], tp)
    out = dict(params)
    for k in train_keys:
        out[k] = tp[k].detach().cpu().numpy()
    return out, host_floats(losses)


def train_lm(
    params: Dict[str, np.ndarray],
    n_layers: int,
    n_heads: int,
    vocab: int,
    seq_len: int = 16,
    steps: int = 300,
    batch: int = 16,
    lr: float = 3e-3,
    seed: int = 0,
    device="cuda",
) -> Tuple[Dict[str, np.ndarray], List[float]]:
    """:func:`adam_steps` over the cyclic language, each step's batch
    seeded from one generator seeded ``seed``.  Returns (params, loss
    history)."""
    rng = np.random.default_rng(seed)
    return adam_steps(
        params, n_layers, n_heads,
        lambda: cyclic_sequences(vocab, seq_len, batch,
                                 seed=int(rng.integers(1 << 30))),
        steps, lr, device)


# ==========================================================================
# Block pruning + INT8 conversion
# ==========================================================================

def prune_lm_blockwise(params: Dict[str, np.ndarray], sparsity: float,
                       block: int = 8) -> Dict[str, np.ndarray]:
    """Per-matrix magnitude block pruning of the six projections of
    each layer (block L2 ranking, blocksparse_train.py semantics)."""
    out = dict(params)
    n_layers = int(params["meta"][0])
    for i in range(n_layers):
        for name in PROJ_NAMES:
            w = params[f"b{i}.{name}"].copy()
            H, W = w.shape
            ph, pw = -H % block, -W % block
            wp = np.pad(w, ((0, ph), (0, pw)))
            t = wp.reshape((H + ph) // block, block,
                           (W + pw) // block, block)
            norms = np.sqrt((t ** 2).sum(axis=(1, 3)))
            n_prune = int(norms.size * sparsity)
            if n_prune == 0:
                continue
            # Exact quota: argsort picks exactly n_prune lowest blocks
            # (a threshold comparison would prune every tied block).
            keep = np.ones(norms.size, bool)
            keep[np.argsort(norms.reshape(-1),
                            kind="stable")[:n_prune]] = False
            mask = np.repeat(np.repeat(keep.reshape(norms.shape),
                                       block, 0), block, 1)
            out[f"b{i}.{name}"] = (w * mask[:H, :W]).astype(np.float32)
    return out


def quantize_lm(params: Dict[str, np.ndarray], n_heads: int,
                block: int = 8) -> TransformerLMInt8:
    """Pack (pruned) fp32 weights into the INT8 BSR serving model."""
    n_layers = int(params["meta"][0])
    blocks = []
    for i in range(n_layers):
        kw = {
            name: _make_projection(params[f"b{i}.{name}"], block,
                                   params[f"b{i}.{name}_b"])
            for name in PROJ_NAMES
        }
        blocks.append(TransformerBlockInt8(
            ln1_g=params[f"b{i}.ln1_g"], ln1_b=params[f"b{i}.ln1_b"],
            ln2_g=params[f"b{i}.ln2_g"], ln2_b=params[f"b{i}.ln2_b"],
            n_heads=n_heads, **kw))
    return TransformerLMInt8(
        embed=params["embed"], pos=params["pos"], blocks=blocks,
        lnf_g=params["lnf_g"], lnf_b=params["lnf_b"])
