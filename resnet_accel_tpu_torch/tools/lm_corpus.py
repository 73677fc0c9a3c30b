"""The corpus LM that the LM tools measure: corpus bytes, then a byte LM of
the serving configuration (d_model 512, 8 heads, d_ff 1024, 4 layers,
max_len 1024) trained by Adam, quantized with 8 x 8 blocks and
calibrated.

Counterpart of ``tools/lm_corpus.py``.  Acceptance of speculative drafts
and sensitivity to KV quantization are properties of the model, so the
subject has to model real text: a random-weight LM measures nothing.

The corpus is the repo's own text that no change to this package edits,
so runs on different checkouts share it (``FROZEN_GLOBS``: the docs, the
JAX package's sources and tools, and its tests); its byte count and sha256
are printed.  ``corpus_bytes`` takes any globs, with the JAX tool's cap of
files a glob.

    python -m resnet_accel_tpu_torch.tools.lm_corpus [--out corpus_lm.json]
"""

from __future__ import annotations

import glob
import hashlib
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from resnet_accel_tpu_torch.runtime.backend import resolve_device
from resnet_accel_tpu_torch.train.lm import (adam_steps, init_lm_fp32,
                                             quantize_lm)
from resnet_accel_tpu_torch.tools import _common

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: The corpus of the card's runs, relative to the repo: files that changes
#: to the port never edit (the port's own tests, ``test_torch_*``, are
#: left out).
FROZEN_GLOBS = ("docs/**/*.md", "resnet_accel_tpu/**/*.py", "tools/*.py",
                "tests/test_*.py")
EXCLUDED_PREFIXES = ("test_torch_",)
#: The serving configuration (tools/lm_corpus.py's defaults).
MAX_LEN, D_MODEL, N_HEADS, N_LAYERS = 1024, 512, 8, 4
#: The training run (tools/lm_corpus.py's defaults).
STEPS, BATCH, SEQ = 1500, 32, 128


def corpus_files(globs: Sequence[str] = FROZEN_GLOBS,
                 max_files_per_glob: Optional[int] = None,
                 root: str = REPO) -> List[str]:
    """The files of ``globs`` (relative ones under ``root``), each glob's
    sorted and cut to ``max_files_per_glob``, in the globs' order."""
    paths = []
    for g in globs:
        found = sorted(p for p in glob.glob(os.path.join(root, g),
                                            recursive=True)
                       if not os.path.basename(p).startswith(
                           EXCLUDED_PREFIXES))
        paths += found[:max_files_per_glob]
    return paths


def corpus_bytes(globs: Sequence[str] = FROZEN_GLOBS,
                 max_files_per_glob: Optional[int] = None,
                 root: str = REPO) -> np.ndarray:
    """The files' bytes joined with ``b"\\n"``, as int32 tokens."""
    parts = []
    for p in corpus_files(globs, max_files_per_glob, root):
        with open(p, "rb") as f:
            parts.append(f.read())
    return np.frombuffer(b"\n".join(parts), np.uint8).astype(np.int32)


def describe(corpus: np.ndarray) -> str:
    """The corpus's byte count and the sha256 of its bytes."""
    digest = hashlib.sha256(corpus.astype(np.uint8).tobytes()).hexdigest()
    return f"corpus: {len(corpus)} bytes, sha256 {digest}"


def batches(data: np.ndarray, rng: np.random.Generator, batch: int,
            seq: int) -> np.ndarray:
    """``batch`` windows of ``seq`` tokens at starts drawn by
    ``rng.integers(0, len(data) - seq - 1, batch)``."""
    starts = rng.integers(0, len(data) - seq - 1, batch)
    return np.stack([data[s:s + seq] for s in starts])


def train_corpus_params(corpus: np.ndarray, max_len: int = MAX_LEN,
                        d_model: int = D_MODEL, n_heads: int = N_HEADS,
                        n_layers: int = N_LAYERS, seq: int = SEQ,
                        steps: int = STEPS, batch: int = BATCH,
                        lr: float = 3e-3, seed: int = 0,
                        holdout_frac: float = 0.0, device="cuda",
                        windows: Optional[list] = None):
    """The float32 training of :func:`train_corpus_lm`: ``adam_steps`` on
    ``batch`` windows a step.  Returns (params, loss history, the trained
    bytes, the held-out tail, seconds).  ``windows``, a list, receives
    each step's token windows."""
    dev = resolve_device(device)
    n_hold = int(len(corpus) * holdout_frac)
    heldout = corpus[len(corpus) - n_hold:]
    train = corpus[:len(corpus) - n_hold]
    params = init_lm_fp32(vocab=256, d_model=d_model, n_heads=n_heads,
                          d_ff=2 * d_model, n_layers=n_layers,
                          max_len=max_len, seed=seed)
    rng = np.random.default_rng(seed)

    def next_batch():
        toks = batches(train, rng, batch, seq)
        if windows is not None:
            windows.append(toks)
        return toks

    _common.sync(dev)
    t0 = time.perf_counter()
    params, losses = adam_steps(params, n_layers, n_heads, next_batch,
                                steps, lr, dev)
    return params, losses, train, heldout, time.perf_counter() - t0


def train_corpus_lm(corpus: np.ndarray, max_len: int = MAX_LEN,
                    d_model: int = D_MODEL, n_heads: int = N_HEADS,
                    n_layers: int = N_LAYERS, seq: int = SEQ,
                    steps: int = STEPS, batch: int = BATCH, lr: float = 3e-3,
                    seed: int = 0, holdout_frac: float = 0.0,
                    device="cuda", stats: Optional[Dict] = None):
    """Train the serving-configuration byte LM on ``corpus``, quantize it
    unpruned with 8 x 8 blocks and calibrate it on the first ``max_len``
    trained bytes.  Returns (model, scales, heldout): heldout is the
    untrained tail, empty when ``holdout_frac`` is 0.  ``stats``, a dict,
    receives the loss history and the training seconds."""
    params, losses, train, heldout, seconds = train_corpus_params(
        corpus, max_len, d_model, n_heads, n_layers, seq, steps, batch, lr,
        seed, holdout_frac, device)
    final = f"{losses[-1]:.3f}" if losses else "none"
    print(f"trained {steps} steps on {len(train)} corpus bytes "
          f"({seconds:.1f} s, final loss {final})", flush=True)
    if stats is not None:
        stats.update(losses=losses, seconds=seconds, steps=steps,
                     train_bytes=int(len(train)),
                     heldout_bytes=int(len(heldout)))
    model = quantize_lm(params, n_heads, block=8)
    scales = model.calibrate(train[:max_len])
    return model, scales, heldout


def main(argv=None) -> int:
    args = _common.parser(__doc__).parse_args(argv)
    dev, label = _common.start(args.device)
    corpus = corpus_bytes()
    print(describe(corpus), flush=True)
    stats: Dict = {}
    model, _, _ = train_corpus_lm(corpus, device=dev, stats=stats)
    h = stats["losses"]
    marks = sorted({0, len(h) // 4, len(h) // 2, 3 * len(h) // 4,
                    len(h) - 1}) if h else []
    print("loss by step: " + ", ".join(f"{i + 1} {h[i]:.4f}" for i in marks))
    tokens = STEPS * BATCH * SEQ
    print(f"{STEPS} steps x {BATCH} x {SEQ} tokens in "
          f"{stats['seconds']:.2f} s: "
          f"{tokens / max(stats['seconds'], 1e-9):.1f} tokens/s (host "
          f"clock){_common.tag(label)}")
    sparsity = float(np.mean(list(
        model.blocks[0].sparsity_report().values())))
    _common.write_out(args.out, {
        "device": label, "corpus": describe(corpus), "steps": STEPS,
        "batch": BATCH, "seconds": stats["seconds"],
        "loss_first": h[0] if h else None, "loss_final": h[-1] if h else None,
        "mean_block_sparsity": sparsity})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
