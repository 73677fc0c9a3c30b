"""Sequence parallelism: the transformer block sharded over tokens.

Counterpart of ``resnet_accel_tpu/parallel/sequence.py``: the int8 sparse
encoder block with its sequence dim sharded over an ``sp`` mesh axis.

- LayerNorm, the projections and the MLP are token-local: each rank runs
  them on its shard.
- Attention: Q stays sharded; K and V are all-gathered over ``sp``, so each
  rank attends its query shard against the whole sequence.
- Dynamic int8 quantization takes a GLOBAL per-tensor scale: the absmax is
  reduced with ``pmax`` over ``sp`` before quantizing, so the shards
  quantize as one device does.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from resnet_accel_tpu_torch.models.transformer import (
    TransformerBlockInt8, TransformerBlockInt8Module)
from resnet_accel_tpu_torch.parallel.collectives import all_gather, pmax
from resnet_accel_tpu_torch.parallel.heads import _need_axis


def make_sp_transformer_forward(mesh: DeviceMesh, block: TransformerBlockInt8,
                                device="cuda") -> Callable:
    """Sequence-parallel forward of the encoder block: fwd(x) takes this
    rank's token shard [T / sp, d_model] and returns its shard of the
    output (full attention over the gathered sequence)."""
    _need_axis(mesh, "sp")
    blk = TransformerBlockInt8Module(block, device)
    H = blk.n_heads

    def q_dyn_global(v):
        s = torch.clamp_min(pmax(v.abs().amax(), mesh, "sp") / blk._c127,
                            1e-12)
        return blk._quant(v, s), s

    def proj(p, v):
        return p.project(*q_dyn_global(v))

    @torch.inference_mode()
    def fwd(x):
        x = torch.as_tensor(x, dtype=torch.float32, device=blk.device)
        Tl, D = x.shape
        dh = D // H
        h = blk._ln(x, blk.ln1_g, blk.ln1_b)
        hq, s = q_dyn_global(h)
        qh, kh, vh = (p.project(hq, s).reshape(Tl, H, dh).transpose(0, 1)
                      for p in (blk.wq, blk.wk, blk.wv))
        # the whole sequence's K and V; Q stays sharded
        k_full = all_gather(kh.contiguous(), mesh, "sp", dim=1)
        v_full = all_gather(vh.contiguous(), mesh, "sp", dim=1)
        ctx = blk._attend(qh, k_full, v_full)
        ctx = ctx.transpose(0, 1).reshape(Tl, D)
        x = x + proj(blk.wo, ctx)
        h = blk._ln(x, blk.ln2_g, blk.ln2_b)
        m = F.gelu(proj(blk.w1, h), approximate="tanh")
        return x + proj(blk.w2, m)
    return fwd
