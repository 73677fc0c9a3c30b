"""Tensor-parallel device programs for the paged-KV serving engine.

Counterpart of ``resnet_accel_tpu/runtime/paged_tp.py``: the PRODUCTION
engine sharded, not a parallel twin.  ``PagedKVBatcher(tp_mesh=...)``
keeps its host scheduler (admission, block tables, the free-page list,
preemption, the prefix cache), replicated in every rank of the mesh, and
runs its device program -- the one ``_forward`` under the chunked
micro-steps, ``score()`` and the speculative verify -- through the
programs built here, the Megatron split of ``parallel.heads`` applied to
the page pools:

- **KV page pools sliced by head**: each rank's pools are ``[n_layers,
  pool_pages, page, d_model / tp]``, its heads' slice of every page, so
  pool memory a rank scales 1/tp.
- ``wq``, ``wk``, ``wv`` and ``w1`` row-sharded per rank; each rank
  computes its heads' Q, K, V, scatters its K/V slice into its pools,
  gathers its page view and runs its heads' attention.
- ``wo`` and ``w2`` replicated; each rank zero-fills the other ranks'
  positions and the int32 accumulators are summed over ``tp`` before
  dequantization: one collective a projection, every integer decision the
  single-device engine's.
- Block tables, lengths, keys, logits and sampling are replicated: every
  rank runs the same scalar program on the summed activations, so the
  host scheduler cannot tell a tp engine from a single-device one, and
  every rank makes the same decisions.
- ``kv_dtype="int8"``: the per-token scale is the GLOBAL row absmax
  (``pmax`` over ``tp``), so each rank's int8 page slice is the
  single-device pool's slice, bit for bit.
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch.distributed.device_mesh import DeviceMesh

from resnet_accel_tpu_torch.parallel.collectives import axis_size, pmax
from resnet_accel_tpu_torch.parallel.heads import (Readout, TPBlock,
                                                   _need_axis)


class TPPagedPrograms:
    """The tp engine's device program in one rank: its blocks' shards, the
    replicated readout and the global row absmax of the int8 pools."""

    def __init__(self, model, scales: List[Dict], mesh: DeviceMesh,
                 device="cuda"):
        _need_axis(mesh, "tp")
        self.mesh, self.tp = mesh, axis_size(mesh, "tp")
        self.blocks = [TPBlock(blk, mesh, "tp", device)
                       for blk in model.blocks]
        self.readout = Readout(model, device)
        self.device = self.readout.device
        self.scales = [tb.prepare_scales(s)
                       for tb, s in zip(self.blocks, scales)]
        self.d_loc = self.blocks[0].d_loc

    def row_absmax(self, val: torch.Tensor) -> torch.Tensor:
        """max |val| over each row's d_model features: this rank's slice's,
        reduced over tp."""
        return pmax(val.abs().amax(dim=-1), self.mesh, "tp")

    def forward(self, eng, toks, pos_idx, lens) -> torch.Tensor:
        """``PagedKVBatcher._forward`` with this rank's heads: tokens [B, S]
        at positions ``pos_idx`` through every block over the paged views
        of this rank's pool slices -> logits [B, S, V], replicated."""
        ro = self.readout
        x = ro.embed[toks] + ro.pos[pos_idx.clamp(max=ro.max_len - 1)]
        prow = (pos_idx // eng.page).clamp(max=eng._table_pages - 1)
        pids = eng._tables.gather(1, prow)
        offs = pos_idx % eng.page
        for li, (tb, s) in enumerate(zip(self.blocks, self.scales)):
            q, k, v = tb.qkv(x, s)
            eng._store(eng._pool_k, li, pids, offs, k)
            eng._store(eng._pool_v, li, pids, offs, v)
            x = tb.attend_mlp(x, q, eng._view(eng._pool_k, li),
                              eng._view(eng._pool_v, li), lens, s)
        return ro.logits(x)


def build_tp_paged_programs(model, scales, mesh: DeviceMesh,
                            device="cuda") -> TPPagedPrograms:
    """The paged engine's device program sharded over the mesh's ``tp``
    axis, for ``PagedKVBatcher(tp_mesh=mesh)``."""
    return TPPagedPrograms(model, scales, mesh, device)
