"""Prompt-lookup speculative decoding against vanilla greedy decoding on the
corpus LM (``TransformerLMInt8.generate_speculative`` against
``generate``).

Counterpart of ``tools/spec_bench.py``: byte prompts of 640 tokens at four
fixed offsets of the corpus, 256 new tokens each, on the corpus-trained
serving-configuration LM (``lm_corpus``).  Each path runs once warm, then
once timed between synchronizations of the card on the host clock.  On the
card both paths run their prefill through K5 (``flash=True``).  Greedy
tokens must be identical, or the tool exits non-zero; with
``--temperature`` > 0, speculative sampling against ``sample`` under the
port's keys (``prng_key(i)``), where only the first token is shared.

    python -m resnet_accel_tpu_torch.tools.spec_bench [--draft 7]
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from resnet_accel_tpu_torch.models.sampling import prng_key
from resnet_accel_tpu_torch.tools import _common
from resnet_accel_tpu_torch.tools.lm_corpus import (MAX_LEN, STEPS,
                                                    corpus_bytes, describe,
                                                    train_corpus_lm)

PROMPT, N_NEW = 640, 256
OFFSETS = (11_000, 60_000, 130_000, 200_000)


def corpus_prompts(corpus: np.ndarray, prompt: int = PROMPT,
                   offsets: Sequence[int] = OFFSETS) -> List[np.ndarray]:
    return [corpus[o:o + prompt] for o in offsets]


def bench_prompt(model, scales, prompt, index: int, n_new: int = N_NEW,
                 draft: int = 7, ngram: int = 3, temperature: float = 0.0,
                 device="cuda", flash: Optional[bool] = None) -> Dict:
    """One prompt through both paths, each warm then timed: the vanilla
    and speculative tokens, the verify passes, the seconds of each and
    whether the outputs agree (greedy: every token; sampled: the first,
    both drawn from ``prng_key(index)``)."""
    dev = model.module(device).device
    if flash is None:
        flash = dev.type == "cuda"
    if temperature > 0:
        exp, tv = _common.timed(
            model.sample, dev, prompt, n_new, scales, prng_key(index),
            temperature=temperature, flash=flash, device=dev)
        (got, steps), ts = _common.timed(
            model.generate_speculative, dev, prompt, n_new, scales,
            draft=draft, ngram=ngram, return_stats=True, flash=flash,
            temperature=temperature, rng_key=prng_key(index), device=dev)
        same = int(exp[0]) == int(got[0])
        label = "tok0-parity"
    else:
        exp, tv = _common.timed(model.generate, dev, prompt, n_new, scales,
                                flash=flash, device=dev)
        (got, steps), ts = _common.timed(
            model.generate_speculative, dev, prompt, n_new, scales,
            draft=draft, ngram=ngram, return_stats=True, flash=flash,
            device=dev)
        same = bool(np.array_equal(exp, got))
        label = "identical"
    return {"vanilla": exp, "speculative": got, "passes": int(steps),
            "vanilla_s": tv, "spec_s": ts, "same": same, "check": label}


def run(model, scales, prompts, n_new: int = N_NEW, draft: int = 7,
        ngram: int = 3, temperature: float = 0.0, device="cuda",
        label: str = "", flash: Optional[bool] = None) -> Dict:
    """Every prompt through :func:`bench_prompt`, printed as the JAX tool
    prints it; raises ``SystemExit`` where the outputs disagree."""
    mode = f"sampled temp={temperature}" if temperature > 0 else "greedy"
    print(f"4L d512 INT8 byte LM (corpus-trained), prompt "
          f"{len(prompts[0])}, new {n_new}, draft {draft}, {mode}",
          flush=True)
    rows, tot_v, tot_s = [], 0.0, 0.0
    for i, p in enumerate(prompts):
        r = bench_prompt(model, scales, p, i, n_new, draft, ngram,
                         temperature, device, flash)
        tot_v += r["vanilla_s"]
        tot_s += r["spec_s"]
        print(f"  prompt[{i}]: vanilla {r['vanilla_s'] * 1e3:7.1f} ms  spec "
              f"{r['spec_s'] * 1e3:7.1f} ms  "
              f"({r['vanilla_s'] / r['spec_s']:4.2f}x)  verify passes "
              f"{r['passes']:3d}/{n_new}  {r['check']}={r['same']}"
              f"{_common.tag(label)}", flush=True)
        rows.append({k: (v.tolist() if isinstance(v, np.ndarray) else v)
                     for k, v in r.items()})
        if not r["same"]:
            raise SystemExit("speculative output diverged")
    tps = n_new * len(prompts) / tot_s
    print(f"TOTAL: vanilla {tot_v * 1e3:.1f} ms  spec {tot_s * 1e3:.1f} ms  "
          f"speedup {tot_v / tot_s:.2f}x ({tps:.0f} tok/s single-stream)"
          f"{_common.tag(label)}", flush=True)
    return {"prompts": rows, "vanilla_s": tot_v, "spec_s": tot_s,
            "speedup": tot_v / tot_s, "spec_tok_s": tps, "draft": draft,
            "ngram": ngram, "temperature": temperature, "n_new": n_new}


def main(argv=None) -> int:
    p = _common.parser(__doc__)
    p.add_argument("--draft", type=int, default=7)
    p.add_argument("--ngram", type=int, default=3)
    p.add_argument("--temperature", type=float, default=0.0)
    args = p.parse_args(argv)
    dev, label = _common.start(args.device)
    corpus = corpus_bytes()
    print(describe(corpus), flush=True)
    prompts = corpus_prompts(corpus)
    model, scales, _ = train_corpus_lm(corpus, max_len=MAX_LEN,
                                       device=dev)
    res = run(model, scales, prompts, draft=args.draft, ngram=args.ngram,
              temperature=args.temperature, device=dev, label=label)
    _common.write_out(args.out, dict(res, device=label,
                                     corpus=describe(corpus),
                                     train_steps=STEPS))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
