"""LM quality on held-out real text: float32 against block-pruned float32
against INT8-sparse bits/byte.

Counterpart of ``tools/lm_quality.py``: a byte LM of the serving width
(d_model 512, 8 heads, 4 layers, sequences of 128) trained by Adam on the
corpus (``lm_corpus.FROZEN_GLOBS``, the last 10 % held out) for 6000
steps with a validation gate every 500 (held-out bits/byte of a 50 KB
slice; the best snapshot is kept); then pruned progressively to 40, 60
and 80 % of its 8 x 8 blocks with masked fine-tunes of 400, 400 and 1200
steps (the masks on the pruned projections only, put back after every
step; the gate every 400 on the last); then quantized to the INT8 BSR
serving model, calibrated on the first 128 trained bytes and scored
teacher-forced (through K5 on the card, ``flash=True``).

    python -m resnet_accel_tpu_torch.tools.lm_quality [--out q.json]
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from resnet_accel_tpu_torch.ops.flash_attention import fp32_matmuls
from resnet_accel_tpu_torch.runtime.backend import resolve_device
from resnet_accel_tpu_torch.tools import _common
from resnet_accel_tpu_torch.tools.lm_corpus import (FROZEN_GLOBS, REPO,
                                                    batches, corpus_bytes,
                                                    describe)
from resnet_accel_tpu_torch.train.lm import (PROJ_NAMES, adam_steps,
                                             init_lm_fp32, lm_forward_fp32,
                                             prune_lm_blockwise, quantize_lm)

__all__ = ["batches", "bits_per_byte_fp32", "bits_per_byte_int8",
           "load_corpus", "run"]

SEQ = 128
D_MODEL = 512       # the serving engines' width (4 layers, 80 % sparse)
N_HEADS = 8
N_LAYERS = 4
STEPS = 6000
BATCH = 32
SPARSITY = 0.8
BLOCK = 8
FT_STEPS = (400, 400, 1200)


def load_corpus(globs: Sequence[str] = FROZEN_GLOBS, root: str = REPO
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(train, held-out): the corpus's first 90 % and the rest."""
    data = corpus_bytes(globs, root=root)
    n_train = int(len(data) * 0.9)
    return data[:n_train], data[n_train:]


def _bpb(nll: Callable, data: np.ndarray, seq: int, limit: int) -> float:
    """Bits a byte: ``nll`` (summed next-token loss of a [n, seq] token
    array) over the first ``limit`` bytes cut into sequences, 64 at a
    time."""
    data = data[:limit]
    n_seq = (len(data) - 1) // seq
    toks = data[:n_seq * seq].reshape(n_seq, seq)
    total, count = 0.0, 0
    for i in range(0, n_seq, 64):
        chunk = toks[i:i + 64]
        total += float(nll(chunk))
        count += chunk.shape[0] * (seq - 1)
    return total / count / np.log(2.0)


def _nll_fp32(tensors: Dict[str, torch.Tensor], n_layers: int,
              n_heads: int, dev: torch.device) -> Callable:
    @torch.no_grad()
    def nll(toks_np):
        toks = torch.from_numpy(toks_np).to(dev).long()
        logits = lm_forward_fp32(tensors, toks, n_layers, n_heads)
        return F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                               toks[:, 1:].reshape(-1), reduction="sum")
    return nll


def bits_per_byte_fp32(params: Dict[str, np.ndarray], data: np.ndarray,
                       n_layers: int, n_heads: int, seq: int = SEQ,
                       limit: int = 100000, device="cuda") -> float:
    """Teacher-forced bits/byte of the float32 LM ``params``."""
    dev = resolve_device(device)
    fp32_matmuls()
    tensors = {k: torch.from_numpy(np.asarray(v, np.float32)).to(dev)
               for k, v in params.items() if k != "meta"}
    return _bpb(_nll_fp32(tensors, n_layers, n_heads, dev), data, seq, limit)


def bits_per_byte_int8(model, scales, data: np.ndarray, seq: int = SEQ,
                       limit: int = 100000, device="cuda",
                       flash: Optional[bool] = None) -> float:
    """Teacher-forced bits/byte of the INT8 serving model (its attention
    through K5 on the card unless ``flash`` is False)."""
    mod = model.module(device)
    sc = mod.prepare_scales(scales)
    if flash is None:
        flash = mod.device.type == "cuda"

    def nll(toks_np):
        toks = torch.from_numpy(toks_np).to(mod.device).long()
        logits = mod.forward(toks, sc, flash=flash)
        return F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                               toks[:, 1:].reshape(-1), reduction="sum")
    return _bpb(nll, data, seq, limit)


def run(train: np.ndarray, held: np.ndarray, steps: int = STEPS,
        ft_steps: Sequence[int] = FT_STEPS, val_every: int = 500,
        ft_val_every: int = 400, gate_limit: int = 50000,
        d_model: int = D_MODEL, n_heads: int = N_HEADS,
        n_layers: int = N_LAYERS, seq: int = SEQ, batch: int = BATCH,
        sparsity: float = SPARSITY, block: int = BLOCK, device="cuda",
        log_every: int = 200, label: str = "") -> Dict:
    """The whole measurement: dense training with its gate, the
    progressive prune with masked fine-tunes, the INT8 model; returns the
    bits/byte and the run's facts.  Adam (lr 3e-3) on one generator seeded
    0 for every batch; a fresh Adam state a stage."""
    dev = resolve_device(device)
    fp32_matmuls()
    t0 = time.perf_counter()
    params = init_lm_fp32(vocab=256, d_model=d_model, n_heads=n_heads,
                          d_ff=2 * d_model, n_layers=n_layers, max_len=seq,
                          seed=0)
    train_keys = [k for k in params if k not in ("meta", "pos")]
    pos = torch.from_numpy(params["pos"]).to(dev)
    rng = np.random.default_rng(0)

    def heldout_bpb(tp):
        bpb = _bpb(_nll_fp32(dict(tp, pos=pos), n_layers, n_heads, dev),
                   held, seq, gate_limit)
        snap = dict(params)
        for k in train_keys:
            snap[k] = tp[k].detach().cpu().numpy()
        return bpb, snap

    def run_steps(start: Dict[str, np.ndarray], n: int, masks: Dict, tag,
                  every: int = 0) -> Dict[str, np.ndarray]:
        """``adam_steps`` from ``start``, logging, and with ``every`` the
        gate: the snapshot of the best held-out bits/byte, else the last
        parameters."""
        best = [float("inf"), None]

        def on_step(s, loss, tp):
            if s % log_every == 0:
                print(f"{tag} step {s:5d} loss {float(loss):.3f} "
                      f"({time.perf_counter() - t0:.0f}s)", flush=True)
            if every and (s + 1) % every == 0:
                bpb, snap = heldout_bpb(tp)
                print(f"{tag} step {s + 1:5d} held-out {bpb:.4f}",
                      flush=True)
                if bpb < best[0]:
                    best[:] = [bpb, snap]

        last, _ = adam_steps(start, n_layers, n_heads,
                             lambda: batches(train, rng, batch, seq), n,
                             device=dev, masks=masks, on_step=on_step)
        return best[1] if best[1] is not None else last

    _common.sync(dev)
    t_dense = time.perf_counter()
    snap = run_steps(params, steps, {}, "dense", val_every)
    for k in train_keys:
        params[k] = snap[k]
    _common.sync(dev)
    dense_s = time.perf_counter() - t_dense
    bpb_fp32 = bits_per_byte_fp32(params, held, n_layers, n_heads, seq,
                                  device=dev)
    print(f"fp32 held-out bits/byte: {bpb_fp32:.4f}{_common.tag(label)}",
          flush=True)

    # masks on the projections the prune touches only: a mask diffed
    # against the dense parameters would freeze zero biases at 0
    pruned = dict(params)
    pruned_keys = {f"b{i}.{n}" for i in range(n_layers) for n in PROJ_NAMES}
    fracs = (sparsity / 2, sparsity * 0.75, sparsity)
    t_ft = time.perf_counter()
    for frac, ft in zip(fracs, ft_steps):
        pruned = prune_lm_blockwise(pruned, frac, block=block)
        masks = {k: (pruned[k] != 0).astype(np.float32)
                 for k in train_keys if k in pruned_keys}
        snap = run_steps(pruned, ft, masks, f"ft@{frac:.0%}",
                            ft_val_every if frac == sparsity else 0)
        for k in train_keys:
            pruned[k] = snap[k]
    _common.sync(dev)
    ft_s = time.perf_counter() - t_ft
    bpb_pruned = bits_per_byte_fp32(pruned, held, n_layers, n_heads, seq,
                                    device=dev)
    print(f"fp32 {sparsity:.0%}-block-pruned+ft bits/byte: "
          f"{bpb_pruned:.4f}{_common.tag(label)}", flush=True)

    model = quantize_lm(pruned, n_heads, block=block)
    cal = train[:512]
    scales = model.calibrate(cal[:model.max_len])
    bpb_int8 = bits_per_byte_int8(model, scales, held, seq, device=dev)
    sp = float(np.mean(list(model.blocks[0].sparsity_report().values())))
    print(f"INT8 sparse (mean block sparsity {sp:.1%}) bits/byte: "
          f"{bpb_int8:.4f}{_common.tag(label)}", flush=True)
    return {
        "train_bytes": int(len(train)), "heldout_bytes": int(len(held)),
        "model": {"d_model": d_model, "layers": n_layers,
                  "heads": n_heads, "seq": seq},
        "fp32_bpb": bpb_fp32, "fp32_pruned_ft_bpb": bpb_pruned,
        "int8_sparse_bpb": bpb_int8,
        "int8_delta_vs_pruned_fp32": bpb_int8 - bpb_pruned,
        "mean_block_sparsity": sp, "prune_sparsity": sparsity,
        "dense_steps": steps, "ft_steps": list(ft_steps), "batch": batch,
        "dense_s": dense_s, "ft_s": ft_s,
        "total_s": time.perf_counter() - t0,
    }


def main(argv=None) -> int:
    args = _common.parser(__doc__).parse_args(argv)
    dev, label = _common.start(args.device)
    train, held = load_corpus()
    print(describe(np.concatenate([train, held])), flush=True)
    print(f"corpus: {len(train)} train / {len(held)} held-out bytes",
          flush=True)
    res = run(train, held, device=dev, label=label)
    print("\n| model | held-out bits/byte |")
    print("|---|---|")
    print(f"| fp32 | {res['fp32_bpb']:.4f} |")
    print(f"| fp32, {SPARSITY:.0%} block-pruned + fine-tuned "
          f"| {res['fp32_pruned_ft_bpb']:.4f} |")
    print(f"| INT8 sparse (BSR serving) | {res['int8_sparse_bpb']:.4f} |")
    print(f"dense {res['dense_s']:.1f} s, fine-tunes {res['ft_s']:.1f} s, "
          f"all {res['total_s']:.1f} s{_common.tag(label)}")
    _common.write_out(args.out, dict(res, device=label,
                                     corpus=describe(np.concatenate(
                                         [train, held]))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
