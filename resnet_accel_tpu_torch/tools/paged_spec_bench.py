"""Speculative decoding inside the paged engine at serving batch sizes.

Counterpart of ``tools/paged_spec_bench.py``: ``PagedKVBatcher(
spec_draft=N)`` (a draft-and-verify window a slot, windows across page
boundaries) on the corpus-trained serving-configuration LM
(``lm_corpus``), at 1, 4 and 8 slots, drafts 0, 7 and 15, float32 and
int8 KV: prompts of 384 corpus bytes, 128 new tokens, greedy streams that
must equal the draft-0 engine's, slot for slot (the tool exits non-zero
otherwise), and the tokens a verify emits, replayed on the host from the
streams (``replay_acceptance``).  Then one sampled configuration (4
slots, draft 7, temperature 0.8, top-k 50: tokens/s and the agreement of
its streams with the draft-0 engine's, distribution-exact but not
stream-exact) and speculation with the prefix cache on a shared system
prompt (streams must equal the uncached engine's).  Each engine runs
twice, the first absorbing start-up, timed on the host clock.  The
engines bypass K5.

    python -m resnet_accel_tpu_torch.tools.paged_spec_bench \\
        [--drafts 0,7,15] [--slots 1,4,8] [--kv fp32,int8]
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from resnet_accel_tpu_torch.runtime.paged import PagedKVBatcher
from resnet_accel_tpu_torch.tools import _common
from resnet_accel_tpu_torch.tools.lm_corpus import (MAX_LEN, corpus_bytes,
                                                    describe,
                                                    train_corpus_lm)

PROMPT, N_NEW = 384, 128


def replay_acceptance(prompts, streams, draft: int, ngram: int = 3) -> float:
    """Tokens emitted a verify, replayed on the host: greedy speculation is
    stream-exact, so the verifies an engine runs are a function of the
    final stream and the draft policy (the engine's own ``_draft``)."""
    drafter = type("D", (), {"spec_ngram": ngram})()
    emitted = verifies = 0
    for p, s in zip(prompts, streams):
        chain, pos = list(p) + list(s), len(p)
        while pos < len(chain):
            d = PagedKVBatcher._draft(drafter, chain[:pos], draft)
            k = 0
            while (k < len(d) and pos + k + 1 < len(chain)
                   and d[k] == chain[pos + k]):
                k += 1
            step = min(k + 1, len(chain) - pos)
            emitted += step
            verifies += 1
            pos += step
    return emitted / max(verifies, 1)


def run_engine(model, scales, slots: int, draft: int, prompts,
               prompt_len: int = PROMPT, n_new: int = N_NEW,
               seeds: Optional[Sequence[int]] = None, device="cuda",
               **kw):
    """Two runs of a fresh engine on ``prompts`` (the first absorbs
    start-up): (tokens/s, seconds, each request's tokens) of the second."""
    need = -(-(prompt_len + n_new + max(draft, 0)) // 16)
    seeds = seeds or [0] * len(prompts)
    out = None
    for _ in range(2):
        b = PagedKVBatcher(model, scales, slots=slots, page=16,
                           pool_pages=slots * need + 2, chunk=8,
                           spec_draft=draft, device=device, **kw)
        rids = [b.submit(p, n_new, seed=s) for p, s in zip(prompts, seeds)]
        _common.sync(b.device)
        t0 = time.perf_counter()
        res = b.run()
        dt = time.perf_counter() - t0
        out = (sum(len(res[r]) for r in rids), dt,
               [tuple(res[r]) for r in rids])
    toks, dt, streams = out
    return toks / dt, dt, streams


def slot_prompts(corpus: np.ndarray, slots: int, prompt: int = PROMPT):
    rng = np.random.default_rng(5)
    offs = rng.integers(0, len(corpus) - prompt - 1, slots)
    return [corpus[o:o + prompt].tolist() for o in offs]


def grid(model, scales, corpus: np.ndarray, drafts: Sequence[int] = (0, 7,
                                                                      15),
         slot_counts: Sequence[int] = (1, 4, 8),
         kv_dtypes: Sequence[str] = ("fp32", "int8"),
         prompt: int = PROMPT, n_new: int = N_NEW, device="cuda",
         label: str = "") -> List[Dict]:
    """Every (kv, slots, draft): tokens/s, relative to draft 0, identical
    streams (``SystemExit`` otherwise) and the replayed acceptance."""
    print(f"{'kv':>5} {'slots':>5} {'draft':>5} {'tok/s':>9} "
          f"{'wall s':>7} {'vs draft=0':>10} {'identical':>9}", flush=True)
    results = []
    for kv in kv_dtypes:
        for slots in slot_counts:
            prompts = slot_prompts(corpus, slots, prompt)
            base_tps, base_out = None, None
            for draft in drafts:
                tps, dt, outs = run_engine(model, scales, slots, draft,
                                           prompts, prompt, n_new,
                                           device=device, kv_dtype=kv)
                if draft == 0:
                    base_tps, base_out = tps, outs
                    rel, ident, acc = 1.0, True, None
                else:
                    rel = tps / base_tps if base_tps else float("nan")
                    ident = outs == base_out
                    acc = replay_acceptance(prompts, outs, draft)
                results.append({"kv": kv, "slots": slots, "draft": draft,
                                "tok_s": tps, "wall_s": dt, "rel": rel,
                                "identical": ident,
                                "accepted_per_verify": acc})
                print(f"{kv:>5} {slots:5d} {draft:5d} {tps:9.1f} "
                      f"{dt:7.2f} {rel:9.2f}x {str(ident):>9}"
                      + (f"  acc/verify {acc:.2f}/{draft + 1}"
                         if acc is not None else "")
                      + f"{_common.tag(label)}", flush=True)
                if base_out is None or not ident:
                    raise SystemExit(
                        f"speculative outputs diverged at kv={kv} "
                        f"slots={slots} draft={draft}")
    return results


def sampled(model, scales, corpus, prompt: int = PROMPT, n_new: int = N_NEW,
            device="cuda", label: str = "") -> Dict:
    slots, draft, temp = 4, 7, 0.8
    prompts = slot_prompts(corpus, slots, prompt)
    seeds = list(range(11, 11 + slots))
    t0, _, s0 = run_engine(model, scales, slots, 0, prompts, prompt, n_new,
                           seeds=seeds, device=device, temperature=temp,
                           top_k=50)
    t1, _, s1 = run_engine(model, scales, slots, draft, prompts, prompt,
                           n_new, seeds=seeds, device=device,
                           temperature=temp, top_k=50)
    agree = float(np.mean([np.mean([x == y for x, y in zip(a, b)])
                           for a, b in zip(s0, s1)]))
    print(f"sampled t={temp} slots={slots} draft={draft}: {t0:.1f} -> "
          f"{t1:.1f} tok/s ({t1 / t0:.2f}x), stream agreement {agree:.3f} "
          f"(distribution-exact, stream-divergent by design)"
          f"{_common.tag(label)}",
          flush=True)
    return {"slots": slots, "draft": draft, "temperature": temp,
            "tok_s_base": t0, "tok_s_spec": t1, "rel": t1 / t0,
            "stream_agreement": agree}


def prefix(model, scales, corpus, prompt: int = PROMPT, n_new: int = N_NEW,
           device="cuda", label: str = "") -> Dict:
    """Speculation over a shared system prompt with and without the
    prefix cache: three runs of one engine each, the third timed."""
    slots, draft = 4, 7
    sys_p = corpus[:prompt - 16].tolist()
    prompts = [sys_p + corpus[1000 + 16 * i:1016 + 16 * i].tolist()
               for i in range(slots)]
    row = {}
    for name, kw in (("plain", {}), ("prefix", {"prefix_cache": True})):
        need = -(-(prompt + n_new + draft) // 16)
        b = PagedKVBatcher(model, scales, slots=slots, page=16,
                           pool_pages=slots * need + 8, chunk=8,
                           spec_draft=draft, device=device, **kw)
        for _ in range(3):          # start-up, then the cache filled
            rids = [b.submit(p, n_new) for p in prompts]
            _common.sync(b.device)
            t0 = time.perf_counter()
            res = b.run()
            dt = time.perf_counter() - t0
        row[name] = {"tok_s": slots * n_new / dt,
                     "streams": [tuple(res[r]) for r in rids]}
    if row["plain"]["streams"] != row["prefix"]["streams"]:
        raise SystemExit("prefix cache changed speculative outputs")
    out = {"slots": slots, "draft": draft,
           "tok_s_plain": row["plain"]["tok_s"],
           "tok_s_prefix": row["prefix"]["tok_s"],
           "rel": row["prefix"]["tok_s"] / row["plain"]["tok_s"]}
    print(f"spec x prefix-cache slots={slots} draft={draft}: "
          f"{out['tok_s_plain']:.1f} -> {out['tok_s_prefix']:.1f} tok/s "
          f"({out['rel']:.2f}x), outputs identical{_common.tag(label)}",
          flush=True)
    return out


def main(argv=None) -> int:
    p = _common.parser(__doc__)
    p.add_argument("--drafts", default="0,7,15")
    p.add_argument("--slots", default="1,4,8")
    p.add_argument("--kv", default="fp32,int8")
    p.add_argument("--prompt", type=int, default=PROMPT)
    p.add_argument("--new", type=int, default=N_NEW)
    p.add_argument("--sampled", type=int, default=1,
                   help="1: the sampled configuration too")
    p.add_argument("--prefix", type=int, default=1,
                   help="1: speculation with the prefix cache too")
    args = p.parse_args(argv)
    dev, label = _common.start(args.device)
    corpus = corpus_bytes()
    print(describe(corpus), flush=True)
    model, scales, _ = train_corpus_lm(corpus, max_len=MAX_LEN,
                                       device=dev)
    res = {"device": label, "corpus": describe(corpus),
           "prompt": args.prompt, "n_new": args.new,
           "model": "4L d512 h8 byte LM (serving config)",
           "grid": grid(model, scales, corpus,
                        [int(d) for d in args.drafts.split(",")],
                        [int(s) for s in args.slots.split(",")],
                        args.kv.split(","), args.prompt, args.new, dev,
                        label)}
    if args.sampled:
        res["sampled"] = sampled(model, scales, corpus, args.prompt,
                                 args.new, dev, label)
    if args.prefix:
        res["prefix"] = prefix(model, scales, corpus, args.prompt, args.new,
                               dev, label)
    _common.write_out(args.out, res)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
