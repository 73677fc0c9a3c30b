"""Tensor (head) parallelism: the transformer block sharded over heads.

Counterpart of ``resnet_accel_tpu/parallel/heads.py``, the Megatron split
adapted to BSR weights and int8 semantics, run in every rank of a mesh
with a ``"tp"`` axis:

- ``wq``, ``wk``, ``wv`` and ``w1`` are ROW-sharded: each rank holds the
  gather-BSR block rows of its heads (of its d_ff slice), a pure slice of
  the packed arrays, and computes only its slice of Q, K, V, its heads'
  attention and its slice of the MLP hidden.
- ``wo`` and ``w2`` stay replicated: each rank zero-fills the positions of
  the other ranks' heads (hidden units), projects, and the int32
  accumulators are summed over ``tp`` (``psum``) BEFORE dequantization, so
  the float math after the reduction is one device's.
- Dynamic int8 quantization of a sharded activation takes the GLOBAL
  absmax (``pmax`` over ``tp``), so every rank quantizes as the unsharded
  block does.

Every integer decision is the single-device block's.  The full forward
(dynamic scales) reassociates float32 sums against the single-device one,
within the JAX tests' bound (2e-5).  The cached decode step, the LM's
generate and the paged engine (``runtime/paged_tp.py``) keep the port's
decode discipline (``models/transformer.py``): every reduction of the
decode path sums in float64 and rounds once, so a rank's heads give the
single-device step's rows and the tokens equal the port's own
``generate``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from resnet_accel_tpu_torch.models.attention import (PackedProjection,
                                                     SparseProjection)
from resnet_accel_tpu_torch.models.transformer import (
    TransformerBlockInt8, TransformerBlockInt8Module)
from resnet_accel_tpu_torch.ops.bsr_matmul import (GatherBSR,
                                                   bsr_matmul_wt_xla,
                                                   pack_gather_bsr)
from resnet_accel_tpu_torch.ops.epilogue import scalar_f32
from resnet_accel_tpu_torch.ops.flash_attention import fp32_matmuls
from resnet_accel_tpu_torch.parallel.collectives import (all_gather,
                                                         axis_index,
                                                         axis_size, pmax,
                                                         psum)
from resnet_accel_tpu_torch.parallel.mesh import batch_sharding
from resnet_accel_tpu_torch.runtime.backend import resolve_device

_ln = TransformerBlockInt8Module._ln
_quant = TransformerBlockInt8Module._quant


def _stack_row_shards(p: SparseProjection, tp: int):
    """Split a projection's gather-BSR arrays into ``tp`` row shards
    (stacked on a new leading axis) plus per-shard scales and bias, numpy:
    (blocks [tp, nbr/tp, lmax, bh, bw], gather_idx [tp, nbr/tp, lmax],
    scales [tp, d_out/tp], bias [tp, d_out/tp])."""
    g = pack_gather_bsr(p.bsr, "cpu")
    nbr = g.blocks.shape[0]
    if nbr % tp or p.d_out % tp:
        raise ValueError(
            f"d_out={p.d_out} (block rows {nbr}) not divisible by tp={tp}")
    per = nbr // tp
    blocks = g.blocks.numpy().reshape(tp, per, *g.blocks.shape[1:])
    gidx = g.gather_idx.numpy().reshape(tp, per, g.lmax)
    scales = np.asarray(p.scales, np.float32).reshape(tp, -1)
    bias = (np.asarray(p.bias, np.float32).reshape(tp, -1)
            if p.bias is not None else np.zeros_like(scales))
    return blocks, gidx, scales, bias


def _local_gather(g: GatherBSR, blocks: torch.Tensor, gidx: torch.Tensor,
                  tp: int) -> GatherBSR:
    """A rank-local GatherBSR view over row-sharded arrays."""
    per, lmax, bh, bw = blocks.shape
    weight = blocks.to(torch.float64).transpose(2, 3).reshape(
        per, lmax * bw, bh).contiguous()
    return dataclasses.replace(
        g, blocks=blocks, gather_idx=gidx, weight=weight,
        n_out=g.n_out // tp, n_padded=g.n_padded // tp)


def _row_shard(p: SparseProjection, tp: int, rank: int,
               device: torch.device) -> PackedProjection:
    """Rank ``rank``'s row shard of ``p`` as a projection on ``device``."""
    blocks, gidx, scales, bias = _stack_row_shards(p, tp)
    full = pack_gather_bsr(p.bsr, "cpu")
    g = _local_gather(full, torch.from_numpy(blocks[rank]),
                      torch.from_numpy(gidx[rank]), tp)
    g = dataclasses.replace(g, **{f: getattr(g, f).to(device) for f in
                                  ("blocks", "gather_idx", "weight")})
    return PackedProjection(
        gather=g, scales=torch.from_numpy(scales[rank].copy()).to(device),
        bias=torch.from_numpy(bias[rank].copy()).to(device))


def _need_axis(mesh: DeviceMesh, axis: str) -> None:
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh must have a '{axis}' axis")


def _zero_filled(part: torch.Tensor, width: int, offset: int
                 ) -> torch.Tensor:
    """``part`` [..., w] at columns offset..offset+w of zeros [..., width]."""
    full = part.new_zeros((*part.shape[:-1], width))
    full[..., offset:offset + part.shape[-1]] = part
    return full


class TPBlock:
    """One :class:`TransformerBlockInt8` as this rank of ``mesh``'s ``axis``
    holds it: its heads' row shards of wq, wk, wv, its slice of w1, the
    replicated wo and w2, on ``device``."""

    def __init__(self, block: TransformerBlockInt8, mesh: DeviceMesh,
                 axis: str = "tp", device="cuda"):
        _need_axis(mesh, axis)
        tp = axis_size(mesh, axis)
        H, D = block.n_heads, block.d_model
        if H % tp:
            raise ValueError(f"n_heads={H} not divisible by tp={tp}")
        self.device = dev = resolve_device(device)
        fp32_matmuls()
        self.mesh, self.axis, self.tp = mesh, axis, tp
        self.rank = axis_index(mesh, axis)
        self.wq, self.wk, self.wv, self.w1 = (
            _row_shard(getattr(block, n), tp, self.rank, dev)
            for n in ("wq", "wk", "wv", "w1"))
        self.wo, self.w2 = block.wo.to(dev), block.w2.to(dev)
        for name in ("ln1_g", "ln1_b", "ln2_g", "ln2_b"):
            setattr(self, name, torch.from_numpy(np.asarray(
                getattr(block, name), np.float32)).to(dev))
        self.n_heads, self.d_model = H, D
        self.h_loc, self.dh = H // tp, D // H
        self.d_loc = self.h_loc * self.dh
        self.d_ff = block.w1.d_out
        self._sqrt_dh = scalar_f32(float(np.sqrt(np.float32(self.dh))), dev)
        self._c127 = scalar_f32(127.0, dev)

    # ------------------------------------------------------------ pieces
    def _scale(self, amax):
        return torch.clamp_min(amax / self._c127, 1e-12)

    def q_dyn_local(self, v):
        """Replicated input: every rank computes the same scale."""
        s = self._scale(v.abs().amax(dim=(-2, -1), keepdim=True))
        return _quant(v, s), s

    def q_dyn_global(self, v):
        """Zero-filled sharded input: the global absmax over tp."""
        s = self._scale(pmax(v.abs().amax(dim=(-2, -1), keepdim=True),
                             self.mesh, self.axis))
        return _quant(v, s), s

    def full_proj_psum(self, p: PackedProjection, q, s):
        """Replicated-weight projection of a zero-filled shard: the int32
        accumulators summed over tp, then dequantized once."""
        lead = q.shape[:-1]
        acc = bsr_matmul_wt_xla(q.reshape(-1, q.shape[-1]), p.gather)
        acc = psum(acc, self.mesh, self.axis).reshape(*lead, -1)
        out = acc.to(torch.float32) * (s * p.scales)
        if p.bias is not None:
            out = out + p.bias
        return out

    def _heads(self, t):
        *lead, T, _ = t.shape
        return t.reshape(*lead, T, self.h_loc, self.dh).transpose(-3, -2)

    def _merge(self, ctx, like):
        return ctx.transpose(-3, -2).reshape(*like.shape[:-1], self.d_loc)

    def _attend(self, q, k, v, mask=None, rows: bool = False):
        """This rank's heads: ``TransformerBlockInt8Module._attend``."""
        dt = torch.float64 if rows else torch.float32
        logits = torch.matmul(q.to(dt), k.to(dt).transpose(-1, -2)) \
            / self._sqrt_dh
        if mask is not None:
            logits = logits.masked_fill(~mask.unsqueeze(-3), float("-inf"))
        return torch.matmul(torch.softmax(logits, dim=-1),
                            v.to(dt)).to(torch.float32)

    # ------------------------------------------------ full forward (JAX's
    # make_tp_transformer_forward program)
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[T, d_model] replicated -> [T, d_model] replicated (dynamic
        scales, full attention)."""
        h = _ln(x, self.ln1_g, self.ln1_b)
        q8, s = self.q_dyn_local(h)
        qh, kh, vh = (self._heads(p.project(q8, s))
                      for p in (self.wq, self.wk, self.wv))
        ctx = self._merge(self._attend(qh, kh, vh), x)
        q8, s = self.q_dyn_global(
            _zero_filled(ctx, self.d_model, self.rank * self.d_loc))
        x = x + self.full_proj_psum(self.wo, q8, s)
        h = _ln(x, self.ln2_g, self.ln2_b)
        q8, s = self.q_dyn_local(h)
        hid = F.gelu(self.w1.project(q8, s), approximate="tanh")
        q8, s = self.q_dyn_global(_zero_filled(
            hid, self.d_ff, self.rank * (self.d_ff // self.tp)))
        return x + self.full_proj_psum(self.w2, q8, s)

    # -------------------------------------- decode path (static scales)
    def qkv(self, x_s, scales):
        """LN1 and this rank's Q, K, V slices of S rows [..., S, d_model]
        -> three [..., S, d_model / tp] (float64 LN statistics)."""
        h = _ln(x_s, self.ln1_g, self.ln1_b, True)
        q8 = _quant(h, scales["h1"])
        return tuple(p.project(q8, scales["h1"])
                     for p in (self.wq, self.wk, self.wv))

    def attend_mlp(self, x_s, q_s, k_all, v_all, pos, scales):
        """This rank's heads over its K/V slice view [..., L, d_model / tp]
        (row i masks positions past ``pos + i``), the psum'd output
        projection and the MLP: ``attend_mlp_multi`` sharded."""
        S, L = x_s.shape[-2], k_all.shape[-2]
        cols = torch.arange(L, device=self.device)
        rows = torch.arange(S, device=self.device)
        if isinstance(pos, int):
            mask = cols <= (pos + rows)[:, None]
        else:
            mask = cols <= (pos[..., None] + rows)[..., None]
        ctx = self._merge(self._attend(self._heads(q_s), self._heads(k_all),
                                       self._heads(v_all), mask, rows=True),
                          x_s)
        full = _zero_filled(ctx, self.d_model, self.rank * self.d_loc)
        x_s = x_s + self.full_proj_psum(
            self.wo, _quant(full, scales["ctx"]), scales["ctx"])
        h = _ln(x_s, self.ln2_g, self.ln2_b, True)
        hid = F.gelu(self.w1.project(_quant(h, scales["h2"]), scales["h2"]),
                     approximate="tanh")
        full = _zero_filled(hid, self.d_ff,
                            self.rank * (self.d_ff // self.tp))
        return x_s + self.full_proj_psum(
            self.w2, _quant(full, scales["mlp"]), scales["mlp"])

    def prepare_scales(self, scales: Dict) -> Dict[str, torch.Tensor]:
        return {tap: s if isinstance(s, torch.Tensor)
                else scalar_f32(float(s), self.device)
                for tap, s in scales.items()}


def make_tp_transformer_forward(mesh: DeviceMesh, block: TransformerBlockInt8,
                                device="cuda") -> Callable:
    """Head-parallel forward of the encoder block: fwd(x [T, d_model]) ->
    [T, d_model], input and output replicated, weights sharded over the
    ``tp`` axis.  Needs n_heads, d_model's and d_ff's block rows divisible
    by the axis size."""
    tb = TPBlock(block, mesh, "tp", device)

    @torch.inference_mode()
    def fwd(x):
        return tb.forward(torch.as_tensor(x, dtype=torch.float32,
                                          device=tb.device))
    return fwd


def _tp_block_cached_step(tb: TPBlock, scales: Dict):
    """Rank-local cached decode step of one block: ``step(x_t, cache)`` with
    ``x_t`` [..., S, d_model] replicated and ``cache`` this rank's head
    slices (``k``, ``v`` [..., max_len, d_model / tp], ``len`` an int) ->
    (y [..., S, d_model] replicated, the cache with ``len`` advanced by S;
    its slices are written in place).  Shared by make_tp_decode_step and
    make_tp_lm_generate, so that the two layouts cannot drift."""
    scales = tb.prepare_scales(scales)

    def step(x_t, cache):
        q, k, v = tb.qkv(x_t, scales)
        pos, S = cache["len"], x_t.shape[-2]
        if pos + S > cache["k"].shape[-2]:
            raise ValueError(f"KV cache full: positions {pos}..{pos + S - 1}"
                             f" exceed max_len {cache['k'].shape[-2]}")
        cache["k"][..., pos:pos + S, :] = k
        cache["v"][..., pos:pos + S, :] = v
        y = tb.attend_mlp(x_t, q, cache["k"], cache["v"], pos, scales)
        return y, {"k": cache["k"], "v": cache["v"], "len": pos + S}
    return step


def make_tp_decode_step(mesh: DeviceMesh, block: TransformerBlockInt8,
                        scales: Dict, max_len: int, device="cuda"):
    """Head-parallel CACHED DECODE, the multi-device serving layout: each
    rank holds only its heads' K/V slice ``[max_len, d_model / tp]`` and the
    one reduction is the int32 ``psum`` inside each output projection.
    Returns ``(init_caches, step)``; ``step(cache, x_t)`` -> ``(y_t [1,
    d_model], cache)`` mirrors ``TransformerBlockInt8Module.decode_step``."""
    tb = TPBlock(block, mesh, "tp", device)
    blk_step = _tp_block_cached_step(tb, scales)

    def init_caches():
        zeros = (max_len, tb.d_loc)
        return {"k": torch.zeros(zeros, device=tb.device),
                "v": torch.zeros(zeros, device=tb.device), "len": 0}

    @torch.inference_mode()
    def step(cache, x_t):
        x_t = torch.as_tensor(x_t, dtype=torch.float32, device=tb.device)
        y, cache = blk_step(x_t, cache)
        return y, cache
    return init_caches, step


class Readout:
    """The LM's embedding, position table, final LayerNorm and tied
    readout on ``device``, replicated in every rank: the decode path's
    ``TransformerLMInt8Module._embed_at`` and ``_logits(rows=True)``."""

    def __init__(self, model, device):
        dev = resolve_device(device)
        for name in ("embed", "pos", "lnf_g", "lnf_b"):
            setattr(self, name, torch.from_numpy(np.asarray(
                getattr(model, name), np.float32)).to(dev))
        self.embed64 = self.embed.to(torch.float64)
        self.max_len = model.max_len
        self.device = dev

    def logits(self, x):
        h = _ln(x, self.lnf_g, self.lnf_b, True)
        return torch.matmul(h.to(torch.float64),
                            self.embed64.T).to(torch.float32)


def make_tp_lm_generate(mesh: DeviceMesh, model, scales, n_new: int,
                        max_len: Optional[int] = None, batched: bool = False,
                        device="cuda"):
    """Head-parallel cached GREEDY GENERATE of the full LM: embedding ->
    every block with per-rank K/V slices -> final LN -> tied readout.  The
    prompt is fed one cached decode step a token, as ``generate(
    parallel_prefill=False)`` does, and the tokens equal it.

    ``batched=True``: ``prompt`` is [B, T] with B sharded over the mesh's
    ``dp`` axis; each dp group generates its rows head-parallel and the
    result is gathered over dp.  Returns a function ``gen(prompt)`` ->
    int32 [n_new] (or [B, n_new]), the same on every rank."""
    _need_axis(mesh, "tp")
    if batched and "dp" not in (mesh.mesh_dim_names or ()):
        raise ValueError("batched=True needs a 'dp' axis")
    ML = model.max_len if max_len is None else max_len
    if ML > model.max_len:
        raise ValueError(f"max_len {ML} exceeds the position table "
                         f"({model.max_len})")
    tbs = [TPBlock(blk, mesh, "tp", device) for blk in model.blocks]
    steps = [_tp_block_cached_step(tb, s) for tb, s in zip(tbs, scales)]
    ro = Readout(model, device)
    dev = ro.device

    @torch.inference_mode()
    def gen(prompt) -> np.ndarray:
        toks = torch.as_tensor(np.asarray(prompt), dtype=torch.long,
                               device=dev)
        if toks.ndim != (2 if batched else 1):
            raise ValueError(f"prompt of shape {tuple(toks.shape)}: "
                             f"expected {'[B, T]' if batched else '[T]'}")
        if batched:
            toks = batch_sharding(toks, mesh, "dp")
        T = toks.shape[-1]
        if T + n_new > ML:
            raise ValueError(f"prompt ({T}) + n_new ({n_new}) exceeds "
                             f"max_len ({ML})")
        lead = toks.shape[:-1]
        caches = [{"k": torch.zeros((*lead, ML, tb.d_loc), device=dev),
                   "v": torch.zeros((*lead, ML, tb.d_loc), device=dev),
                   "len": 0} for tb in tbs]

        def decode(tok, pos):
            x = (ro.embed[tok] + ro.pos[pos])[..., None, :]
            for i, st in enumerate(steps):
                x, caches[i] = st(x, caches[i])
            return ro.logits(x)[..., 0, :].argmax(dim=-1)

        for t in range(T):                                 # prefill
            nxt = decode(toks[..., t], t)
        out = [nxt]
        for t in range(T, T + n_new - 1):
            nxt = decode(nxt, t)
            out.append(nxt)
        res = torch.stack(out, dim=-1)[..., :n_new]
        if batched:
            res = all_gather(res, mesh, "dp", dim=0)
        return res.cpu().numpy().astype(np.int32)
    return gen
