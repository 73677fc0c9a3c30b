"""Temperature and top-k sampling and speculative acceptance, with the
port's own random streams.

Counterpart of the sampling functions of ``resnet_accel_tpu/models/lm.py``
(``sampled_token``, ``adjust_logits``, ``spec_accept_sampled``), which the
LM's ``sample`` and ``generate_speculative`` and both batchers share, so
that a batcher's streams equal ``sample``'s.  Every function takes leading
dimensions: one call serves every slot of a batcher.

**Random streams.**  PyTorch cannot reproduce ``jax.random``'s threefry
streams, so the port carries its own explicit keys:

- A key is two 32-bit lanes held in an int64 tensor ``[..., 2]``, made from
  a request's seed by :func:`prng_key`.  There is no global generator
  state: nothing here calls ``torch.manual_seed``.
- :func:`split` derives child keys.  Each consumed token splits its key
  once, as the JAX package's ``jax.random.split`` does, so a key advances
  exactly where the JAX code advances its own.
- The bits are a counter-based hash of the key and a counter: three rounds
  of the ``lowbias32`` mixer, each a bijection on 32 bits.  Every product
  is formed from 16-bit halves of the constant, so no intermediate exceeds
  2^48 and the int64 lanes never overflow: the same bits on the CPU and on
  the card, whatever the shape, and one vectorized call for all slots.
- A categorical draw is Gumbel-max over uniforms in the open interval
  (0, 1), as ``jax.random.categorical`` is.

A ``torch.Generator`` per slot was the alternative; it cannot be stacked
across slots, and its streams differ between the CPU and CUDA.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

_M32 = 0xFFFFFFFF
#: Domain tags, so that key derivation and draws never share a counter.
_TAG_SEED, _TAG_SPLIT, _TAG_BITS = 0x243F6A88, 0x85A308D3, 0x13198A2E


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c`` modulo 2^32 for x < 2^32 held in int64: the constant in two
    16-bit halves, so every product stays below 2^48."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix(x: torch.Tensor) -> torch.Tensor:
    """``lowbias32``: a bijection on 32-bit values with full avalanche."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _hash(key: torch.Tensor, ctr: torch.Tensor, tag: int) -> torch.Tensor:
    """32 bits for every counter: key [..., 2], ctr of shape C ->
    [..., *C].  For one key, distinct counters give distinct bits."""
    expand = (slice(None),) * (key.ndim - 1) + (None,) * ctr.ndim
    k0 = key[..., 0][expand]
    k1 = key[..., 1][expand]
    return _mix(k1 ^ _mix((k0 ^ tag) ^ _mix(ctr)))


def prng_key(seed: int, device: Union[str, torch.device] = "cpu"
             ) -> torch.Tensor:
    """The key of ``seed`` (any Python int), an int64 tensor [2]."""
    lanes = torch.tensor([(seed >> 32) & _M32, seed & _M32],
                         dtype=torch.int64, device=device)
    return _hash(lanes, torch.arange(2, device=device), _TAG_SEED)


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``n`` child keys of each key: [..., 2] -> [..., n, 2]."""
    ctr = torch.arange(2 * n, device=key.device).view(n, 2)
    return _hash(key, ctr, _TAG_SPLIT)


def uniform(key: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` float32 uniforms in the open interval (0, 1) for each key,
    [..., n]: 23 bits each, as (2b + 1) / 2^24."""
    bits = _hash(key, torch.arange(n, device=key.device), _TAG_BITS)
    return ((bits >> 9) * 2 + 1).to(torch.float32) * (2.0 ** -24)


def categorical(key: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """One draw from softmax(z) along the last axis for each key (key
    [..., 2], z [..., V]): the argmax of z plus Gumbel noise, the noise in
    float64.  Entries at -inf are never drawn."""
    u = uniform(key, z.shape[-1]).to(torch.float64)
    return (z.to(torch.float64) - torch.log(-torch.log(u))).argmax(dim=-1)


def adjust_logits(logits: torch.Tensor, temperature: float,
                  top_k: Optional[int] = None) -> torch.Tensor:
    """Temperature and optional top-k truncation, as ``sampled_token``
    applies them: divide by the temperature rounded once to float32, then
    mask every value below the k-th largest.  Values equal to the k-th
    stay, so ties may keep more than k."""
    z = logits / torch.tensor(np.float32(temperature), device=logits.device)
    if top_k is not None and top_k < z.shape[-1]:
        kth = torch.topk(z, top_k, dim=-1).values[..., -1:]
        z = z.masked_fill(z < kth, float("-inf"))
    return z


def sampled_token(logits: torch.Tensor, key: torch.Tensor,
                  temperature: float, top_k: Optional[int] = None):
    """One stochastic draw, shared by ``sample`` and the batchers: split the
    key, adjust the logits, draw.  Returns (next key, token)."""
    keys = split(key)
    z = adjust_logits(logits, temperature, top_k)
    return keys[..., 0, :], categorical(keys[..., 1, :], z)


def pick_tokens(logits: torch.Tensor, keys: torch.Tensor,
                advance: torch.Tensor, temperature: float,
                top_k: Optional[int]):
    """The batchers' per-slot choice (logits [B, V], keys [B, 2], advance
    [B] bool): the argmax everywhere, or, when sampling, the shared draw on
    the slots whose output is a consumed token, whose keys alone advance.
    Returns (tokens [B], keys)."""
    greedy = logits.argmax(dim=-1)
    if temperature <= 0.0:
        return greedy, keys
    k2, drawn = sampled_token(logits, keys, temperature, top_k)
    return (torch.where(advance, drawn, greedy),
            torch.where(advance[:, None], k2, keys))


def greedy_accept(logits: torch.Tensor, fed: torch.Tensor, n_known=1):
    """Greedy acceptance of a verify pass (logits [..., S, V], fed [...,
    S]): a draft survives while it equals the model's own argmax chain, and
    the leading ``n_known`` fed tokens are known and always accepted.
    Returns (accepted drafts [...], the argmax chain [..., S])."""
    g = logits.argmax(dim=-1)
    S = fed.shape[-1]
    forced = torch.arange(1, S, device=fed.device) < _lead(n_known)
    ok = torch.cumprod((forced | (fed[..., 1:] == g[..., :-1])).long(), -1)
    return ok.sum(dim=-1), g


def _lead(n):
    """An int, or a tensor of the lead shape made to broadcast against a
    trailing axis."""
    return n[..., None] if isinstance(n, torch.Tensor) else n


def spec_accept_sampled(z: torch.Tensor, fed: torch.Tensor,
                        key: torch.Tensor, n_known=1):
    """One speculative-sampling accept/emit step for a deterministic draft
    (prompt lookup proposes a point mass).

    ``z`` [..., S, V]: adjusted logits of the verify pass, row i the target
    distribution of the token after ``fed[i]``; ``fed`` [..., S]: the last
    emitted token, then the drafts; ``n_known``: how many leading fed
    tokens are known (a prompt being ingested) and accepted whatever the
    draw.  Draft d_i is accepted with probability p_i(d_i); the first
    rejection draws from softmax(z_i) with z_i[d_i] at -inf; if every draft
    survives, the bonus token comes from the last row.  Every emitted token
    is so distributed exactly as sequential sampling from the target.
    Returns (n_acc [...], emit [..., S], next key): ``emit[:n_acc]`` are
    the accepted drafts and ``emit[n_acc]`` the step token."""
    S, V = z.shape[-2:]
    keys = split(key, 3)
    key, k_u, k_s = keys[..., 0, :], keys[..., 1, :], keys[..., 2, :]
    logp = torch.log_softmax(z, dim=-1)
    p_draft = logp[..., :S - 1, :].gather(
        -1, fed[..., 1:, None]).squeeze(-1).exp()
    forced = torch.arange(1, S, device=z.device) < _lead(n_known)
    ok = torch.cumprod((forced | (uniform(k_u, S - 1) < p_draft)).long(),
                       -1)
    n_acc = ok.sum(dim=-1)
    zj = z.gather(-2, n_acc[..., None, None].expand(
        *n_acc.shape, 1, V)).squeeze(-2)
    d = fed.gather(-1, (n_acc + 1).clamp(max=S - 1)[..., None])
    drop = (n_acc < S - 1)[..., None] & (
        torch.arange(V, device=z.device) == d)
    step_tok = categorical(k_s, zj.masked_fill(drop, float("-inf")))
    shifted = torch.cat([fed[..., 1:], torch.zeros_like(fed[..., :1])], -1)
    emit = torch.where(torch.arange(S, device=z.device) == n_acc[..., None],
                       step_tok[..., None], shifted)
    return n_acc, emit, key
