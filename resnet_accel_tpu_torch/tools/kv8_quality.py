"""Int8 KV pages against float32 ones where they can fail, on the corpus
LM.

Counterpart of ``tools/kv8_quality.py``, on the corpus-trained
serving-configuration LM (``lm_corpus``, the last 10 % of the corpus held
out):

1. Held-out bits/byte through the paged engine (``PagedKVBatcher.score``:
   the paged scatter and gather and the quantized pages) at ctx 128, 512
   and 768, 12 windows each, float32 KV against int8 KV, with the mean
   |delta log-prob|.
2. Greedy token agreement from 512-token prompts, 128 new tokens.
3. Sampled streams (temperature 0.8, top-k 50) over 12 seeds, each engine
   reseeded a stream with ``seed=1000 + s`` under the port's keys: tokens
   agree until a logit's wiggle flips a draw, so the first divergence is
   the statistic.

The engines bypass K5 (they ingest prompts by decode steps).

    python -m resnet_accel_tpu_torch.tools.kv8_quality [--out kv8.json]
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Sequence

import numpy as np

from resnet_accel_tpu_torch.runtime.paged import PagedKVBatcher
from resnet_accel_tpu_torch.tools import _common
from resnet_accel_tpu_torch.tools.lm_corpus import (MAX_LEN, STEPS,
                                                    corpus_bytes, describe,
                                                    train_corpus_lm)

CTXS = (128, 512, 768)
N_WINDOWS = 12          # held-out windows a ctx
GEN_PROMPT, GEN_NEW = 512, 128
SAMP_PROMPT, SAMP_NEW = 256, 64
SEEDS = 12
TEMP, TOP_K = 0.8, 50


def engines(model, scales, device="cuda") -> Callable:
    """``mk(kv, temp=0.0)``: a fresh engine of 4 slots, 16-token pages, a
    pool of 260 pages and chunks of 16, with ``kv`` pages."""
    def mk(kv, temp=0.0):
        return PagedKVBatcher(
            model, scales, slots=4, page=16, pool_pages=260, chunk=16,
            kv_dtype=kv, temperature=temp,
            top_k=TOP_K if temp > 0 else None, device=device)
    return mk


def ppl_row(mk: Callable, heldout: np.ndarray, ctx: int,
            rng: np.random.Generator, n_windows: int = N_WINDOWS) -> Dict:
    """Bits/byte of ``n_windows`` held-out windows of ``ctx`` tokens (their
    starts drawn from ``rng``) with float32 and int8 KV."""
    offs = rng.integers(0, len(heldout) - ctx - 1, n_windows)
    seqs = [heldout[o:o + ctx].tolist() for o in offs]
    cat_fp = np.concatenate(mk("fp32").score(seqs))
    cat_q8 = np.concatenate(mk("int8").score(seqs))
    bpb_fp = float(-cat_fp.mean() / np.log(2))
    bpb_q8 = float(-cat_q8.mean() / np.log(2))
    return {"ctx": int(ctx), "tokens": int(cat_fp.size),
            "bpb_fp32_kv": bpb_fp, "bpb_int8_kv": bpb_q8,
            "delta_bpb": bpb_q8 - bpb_fp,
            "mean_abs_dlogp": float(np.abs(cat_fp - cat_q8).mean())}


def _agreement(pairs) -> Dict:
    agree, total, first_div = 0, 0, []
    for ta, tb in pairs:
        same = [x == y for x, y in zip(ta, tb)]
        agree += sum(same)
        total += len(same)
        first_div.append(same.index(False) if False in same else len(same))
    return {"agreement": agree / max(total, 1),
            "agree_tokens": agree, "tokens": total,
            "first_divergence": first_div}


def greedy_agreement(mk: Callable, heldout: np.ndarray,
                     rng: np.random.Generator, prompt: int = GEN_PROMPT,
                     new: int = GEN_NEW, streams: int = 4) -> Dict:
    """Greedy streams of float32- and int8-KV engines from ``streams``
    held-out prompts: the share of equal tokens and each stream's first
    divergence."""
    offs = rng.integers(0, len(heldout) - prompt - 1, streams)
    prompts = [heldout[o:o + prompt].tolist() for o in offs]
    e_fp, e_q8 = mk("fp32"), mk("int8")
    r_fp = [e_fp.submit(p, new) for p in prompts]
    r_q8 = [e_q8.submit(p, new) for p in prompts]
    o_fp, o_q8 = e_fp.run(), e_q8.run()
    out = _agreement((o_fp[a], o_q8[b]) for a, b in zip(r_fp, r_q8))
    return dict(out, prompt=prompt, new=new, streams=streams)


def sampled_agreement(mk: Callable, heldout: np.ndarray,
                      rng: np.random.Generator, seeds: int = SEEDS,
                      prompt: int = SAMP_PROMPT, new: int = SAMP_NEW,
                      temp: float = TEMP) -> Dict:
    """Sampled streams of both engines, stream ``s`` seeded ``1000 + s``
    in each."""
    offs = rng.integers(0, len(heldout) - prompt - 1, seeds)
    pairs = []
    for s in range(seeds):
        p = heldout[offs[s]:offs[s] + prompt].tolist()
        e_fp, e_q8 = mk("fp32", temp), mk("int8", temp)
        ra = e_fp.submit(p, new, seed=1000 + s)
        rb = e_q8.submit(p, new, seed=1000 + s)
        pairs.append((e_fp.run()[ra], e_q8.run()[rb]))
    out = _agreement(pairs)
    return dict(out, temperature=temp, top_k=TOP_K, prompt=prompt, new=new,
                seeds=seeds)


def measure(model, scales, heldout: np.ndarray, device="cuda",
            ctxs: Sequence[int] = CTXS, n_windows: int = N_WINDOWS,
            greedy: bool = True, seeds: int = SEEDS, label: str = ""
            ) -> Dict:
    """The three parts in the JAX tool's order, on one generator seeded 0
    (``seeds`` 0 leaves out the sampled part, ``greedy`` False the greedy
    one)."""
    mk = engines(model, scales, device)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    results: Dict = {"ppl": [], "greedy": None, "sampled": None}
    for ctx in ctxs:
        row = ppl_row(mk, heldout, ctx, rng, n_windows)
        results["ppl"].append(row)
        print(f"ctx {ctx:4d}: bpb fp32-KV {row['bpb_fp32_kv']:.4f} int8-KV "
              f"{row['bpb_int8_kv']:.4f} (delta {row['delta_bpb']:+.4f}, "
              f"mean|dlogp| {row['mean_abs_dlogp']:.4f}) "
              f"[{time.perf_counter() - t0:.0f}s]{_common.tag(label)}",
              flush=True)
    if greedy:
        g = greedy_agreement(mk, heldout, rng)
        results["greedy"] = g
        print(f"greedy ctx {g['prompt']}+{g['new']}: agreement "
              f"{g['agree_tokens']}/{g['tokens']} first-div "
              f"{g['first_divergence']} [{time.perf_counter() - t0:.0f}s]",
              flush=True)
    if seeds:
        s = sampled_agreement(mk, heldout, rng, seeds)
        results["sampled"] = s
        print(f"sampled T={s['temperature']} {seeds} seeds: agreement "
              f"{s['agree_tokens']}/{s['tokens']} first-div "
              f"{sorted(s['first_divergence'])} "
              f"[{time.perf_counter() - t0:.0f}s]", flush=True)
    return results


def main(argv=None) -> int:
    args = _common.parser(__doc__).parse_args(argv)
    dev, label = _common.start(args.device)
    corpus = corpus_bytes()
    print(describe(corpus), flush=True)
    model, scales, heldout = train_corpus_lm(
        corpus, max_len=MAX_LEN, holdout_frac=0.1, device=dev)
    res = measure(model, scales, heldout, dev, label=label)
    res.update(device=label, corpus=describe(corpus),
               model="4L d512 h8 byte LM (serving config), trained "
                     f"{STEPS} steps on {len(corpus) - len(heldout)} "
                     f"corpus bytes, held-out {len(heldout)}")
    _common.write_out(args.out, res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
