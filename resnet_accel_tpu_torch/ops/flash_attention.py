"""Attention with an online softmax: kernel K5 and its plain version.

Counterpart of ``resnet_accel_tpu/ops/flash_attention.py``.  For q, k, v
float32 [H, T, dh] both versions compute, per head and row,

    o = softmax(q @ k^T * scale, keys j >= T masked, and j > t masked
                when causal) @ v                       -> float32 [H, T, dh]

with ``scale`` 1 / sqrt(dh) by default.  ``flash_attention`` launches the
CUDA kernel ``csrc/flash_attention.cu`` for CUDA tensors, which never
writes the [T, T] scores to device memory, and runs
:func:`flash_attention_plain` for CPU tensors.

The kernel cuts each 64-row q tile's visible key tiles into chunks and
runs one CTA a (head, q tile, chunk); :func:`flash_plan` gives it the
chunk size.  The plan depends on T and the mask alone, never on the
number of heads, so a head's rows are the same bits in any batch.  Its
products run on the tensor cores in split precision (3xTF32).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from resnet_accel_tpu_torch import _kernels


def fp32_matmuls() -> None:
    """Turn TF32 off for float32 products and convolutions on the card: the
    JAX package computes them at HIGHEST precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _check_qkv(q, k, v):
    if q.ndim != 3:
        raise ValueError(f"q must be [H, T, dh], got shape {tuple(q.shape)}")
    H, T, dh = q.shape
    if tuple(k.shape) != (H, T, dh) or tuple(v.shape) != (H, T, dh):
        raise ValueError(f"q/k/v shape mismatch: {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    return H, T, dh


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch version: the float32 scores materialised (TF32 off),
    masked with -inf, softmax, then @ v."""
    _, T, dh = _check_qkv(q, k, v)
    if scale is None:
        scale = 1.0 / float(np.sqrt(dh))
    fp32_matmuls()
    s = torch.matmul(q, k.transpose(1, 2)) * scale
    if causal:
        mask = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    return torch.matmul(torch.softmax(s, dim=-1), v)


#: q rows a CTA, keys a key tile, chunks a q tile at most, key tiles a
#: chunk at least: the kernel's.
FA_ROWS, FA_MAX_CHUNKS, FA_MIN_CHUNK = 64, 8, 2


def flash_plan(T: int, dh: int, causal: bool) -> Tuple[int, int]:
    """What the wrapper hands ``csrc/flash_attention.cu`` for T rows: (ct,
    ws_floats).  Of nq tiles of 64 rows, q tile i sees key tiles [0, i + 1)
    (causal) or [0, nq), cut into chunks of ct = max(2, ceil(nq / 8))
    tiles; the kernel runs one CTA a (q tile, chunk) item.  ``ws_floats``
    is a head's share of the partials' workspace: an acc tile at the
    kernel's padded dh and 64 (m, l) pairs an item, or 0 where every q
    tile has one chunk and writes its rows itself."""
    nq = -(-T // FA_ROWS)
    ct = max(FA_MIN_CHUNK, -(-nq // FA_MAX_CHUNKS))
    chunks = [-(-(qt + 1 if causal else nq) // ct) for qt in range(nq)]
    if max(chunks, default=0) <= 1:
        return ct, 0
    dh_pad = next(d for d in (16, 32, 64, 128) if dh <= d)
    return ct, sum(chunks) * (FA_ROWS * dh_pad + 2 * FA_ROWS)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """softmax(q k^T * scale [+ causal mask]) v without the [T, T] scores
    in device memory.  q, k, v: float32 [H, T, dh], contiguous; the kernel
    takes dh <= 128."""
    H, T, dh = _check_qkv(q, k, v)
    if scale is None:
        scale = 1.0 / float(np.sqrt(dh))
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if dh > 128 or H > 65535:
        raise ValueError(f"flash_attention kernel needs dh <= 128 and "
                         f"H <= 65535, got H={H}, dh={dh}")
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        _kernels.check(t, name, torch.float32, (H, T, dh), dev)
    out = torch.empty_like(q)
    if H * T * dh == 0:
        return out
    ct, ws_floats = flash_plan(T, dh, causal)
    ws = torch.empty(H * ws_floats, dtype=torch.float32, device=dev) \
        if ws_floats else None
    _kernels.launch("flash_attention", dev, q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), out.data_ptr(),
                    None if ws is None else ws.data_ptr(), H, T, dh,
                    int(causal), ct, float(scale))
    return out
