"""Paged-KV serving throughput at long contexts.

Counterpart of ``tools/paged_bench.py``: end-to-end request throughput of
``PagedKVBatcher`` (prefill included) on a seeded 4-layer d_model-256 INT8
LM at 50 % block sparsity, 4 slots, 32-token pages, chunks of 16, at
contexts 64, 256 and 512; at 512 also a pool oversubscribed 1.67x with
pages on demand (preemption by recompute: its tokens must equal the full
pool's, or the tool exits non-zero) and int8 KV pages (token agreement
printed, lossy by design); then a system-prompt workload (352 shared +
32 unique prompt tokens, 96 new) with the prefix cache off and on.  Each
configuration runs once warm, then once timed on the host clock; prompts
are fixed by seed, so every pool variant serves the same requests.  The
engines bypass K5 (they ingest prompts by decode steps).

    python -m resnet_accel_tpu_torch.tools.paged_bench [--out p.json]
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np

from resnet_accel_tpu_torch.models.lm import TransformerLMInt8
from resnet_accel_tpu_torch.runtime.paged import PagedKVBatcher
from resnet_accel_tpu_torch.tools import _common

#: The measured LM (tools/paged_bench.py's).
MODEL = dict(vocab=256, d_model=256, n_heads=8, n_layers=4, sparsity=0.5)
CONTEXTS = ((64, 24, 32), (256, 128, 96), (512, 384, 96))


def _model(max_len: int, model_kw: Optional[Dict]):
    kw = dict(MODEL, **(model_kw or {}))
    model = TransformerLMInt8.from_random(seed=0, max_len=max_len, **kw)
    rng = np.random.default_rng(1)
    return model, model.calibrate(rng.integers(0, 256, 32))


def measure(max_len: int, prompt_len: int, n_new: int, slots: int = 4,
            page: int = 32, chunk: int = 16, oversub: float = 1.0,
            reserve: str = "full", kv_dtype: str = "fp32", device="cuda",
            model_kw: Optional[Dict] = None):
    """(tokens/s, seconds, pool pages, paged KV MiB, fixed-slot KV MiB,
    each request's tokens) of the timed run."""
    model, scales = _model(max_len, model_kw)
    full_pool = slots * (-(-(prompt_len + n_new) // page)) + 1
    pool = max(2 + (-(-(prompt_len + n_new) // page)),
               int(round(full_pool / oversub)))
    b = PagedKVBatcher(model, scales, slots=slots, page=page,
                       pool_pages=pool, chunk=chunk, reserve=reserve,
                       kv_dtype=kv_dtype, device=device)

    def load(seed):
        prng = np.random.default_rng(seed)
        return [b.submit(prng.integers(0, 256, prompt_len).tolist(), n_new)
                for _ in range(slots)]

    load(0)
    b.run()                     # warm
    rids = load(1)
    _common.sync(b.device)
    t0 = time.perf_counter()
    res = b.run()
    dt = time.perf_counter() - t0
    toks = sum(len(res[r]) for r in rids)
    D, L = model.d_model, len(model.blocks)
    paged_mb = b.kv_pool_bytes() / 2**20
    fixed_mb = 2 * 4 * L * slots * max_len * D / 2**20
    outs = tuple(tuple(res[r]) for r in rids)
    return toks / dt, dt, pool, paged_mb, fixed_mb, outs


def measure_prefix(max_len: int = 512, sys_len: int = 352, uniq: int = 32,
                   n_new: int = 96, slots: int = 4, page: int = 32,
                   chunk: int = 16, cache: bool = True, device="cuda",
                   model_kw: Optional[Dict] = None):
    """System-prompt workload: each request is a shared ``sys_len``-token
    prefix and ``uniq`` tokens of its own.  (tokens/s, seconds, prompt
    tokens the prefix cache skipped, each request's tokens)."""
    model, scales = _model(max_len, model_kw)
    prompt_len = sys_len + uniq
    pool = (slots + 1) * (-(-(prompt_len + n_new) // page)) + 1
    b = PagedKVBatcher(model, scales, slots=slots, page=page,
                       pool_pages=pool, chunk=chunk, prefix_cache=cache,
                       device=device)
    sys_prompt = np.random.default_rng(7).integers(0, 256, sys_len).tolist()

    def load(seed):
        prng = np.random.default_rng(seed)
        return [b.submit(sys_prompt + prng.integers(0, 256, uniq).tolist(),
                         n_new) for _ in range(slots)]

    load(0)
    b.run()                     # warm; with the cache on, fills it
    skipped0 = b.cache_tokens_skipped
    rids = load(1)
    _common.sync(b.device)
    t0 = time.perf_counter()
    res = b.run()
    dt = time.perf_counter() - t0
    toks = sum(len(res[r]) for r in rids)
    return (toks / dt, dt, b.cache_tokens_skipped - skipped0,
            tuple(tuple(res[r]) for r in rids))


def ctx_rows(max_len: int, prompt: int, n_new: int, device="cuda",
             label: str = "", oversub: bool = True, int8: bool = True,
             model_kw: Optional[Dict] = None) -> Dict:
    """One context's row, with the oversubscribed pool (its tokens must
    equal the full pool's; ``SystemExit`` otherwise) and int8 KV."""
    tps, dt, pool, pmb, fmb, outs = measure(max_len, prompt, n_new,
                                            device=device, model_kw=model_kw)
    print(f"{max_len:6d} {prompt:7d} {n_new:5d} {pool:5d} {tps:9.1f} "
          f"{dt:7.2f} {pmb:6.2f} {fmb:9.2f}{_common.tag(label)}", flush=True)
    row = {"ctx": max_len, "prompt": prompt, "new": n_new, "pool": pool,
           "tok_s": tps, "wall_s": dt, "kv_mb": pmb, "fixed_mb": fmb}
    if oversub:
        tps2, dt2, pool2, pmb2, _, outs2 = measure(
            max_len, prompt, n_new, oversub=1.67, reserve="ondemand",
            device=device, model_kw=model_kw)
        same = outs2 == outs
        print(f"{max_len:6d} {prompt:7d} {n_new:5d} {pool2:5d} {tps2:9.1f} "
              f"{dt2:7.2f} {pmb2:6.2f}       oversub x1.67 ondemand, "
              f"outputs identical={same}", flush=True)
        row["oversub"] = {"pool": pool2, "tok_s": tps2, "wall_s": dt2,
                          "kv_mb": pmb2, "identical": same}
        if not same:
            raise SystemExit("oversubscribed outputs diverged")
    if int8:
        tps3, dt3, pool3, pmb3, _, outs3 = measure(
            max_len, prompt, n_new, kv_dtype="int8", device=device,
            model_kw=model_kw)
        agree = sum(x == y for a, c in zip(outs, outs3)
                    for x, y in zip(a, c))
        total = sum(len(a) for a in outs)
        print(f"{max_len:6d} {prompt:7d} {n_new:5d} {pool3:5d} {tps3:9.1f} "
              f"{dt3:7.2f} {pmb3:6.2f}       int8 KV, token agreement "
              f"{agree}/{total}", flush=True)
        row["int8"] = {"pool": pool3, "tok_s": tps3, "wall_s": dt3,
                       "kv_mb": pmb3, "agree": agree, "tokens": total}
    return row


def main(argv=None) -> int:
    p = _common.parser(__doc__)
    args = p.parse_args(argv)
    dev, label = _common.start(args.device)
    print(f"{'ctx':>6} {'prompt':>7} {'new':>5} {'pool':>5} {'tok/s':>9} "
          f"{'wall s':>7} {'KV MB':>6} {'fixed MB':>9}")
    rows = [ctx_rows(m, pr, n, dev, label, oversub=m == 512, int8=m == 512)
            for m, pr, n in CONTEXTS]
    prefix = {}
    for cache in (False, True):
        tps, dt, skipped, outs = measure_prefix(cache=cache, device=dev)
        prefix[str(cache)] = {"tok_s": tps, "wall_s": dt,
                              "skipped": skipped, "outs": outs}
        print(f"sys-prompt 352+32, new 96, prefix_cache={cache}: "
              f"{tps:9.1f} tok/s  wall {dt:.2f}s  prefill skipped "
              f"{skipped} tok{_common.tag(label)}", flush=True)
    if prefix["False"]["outs"] != prefix["True"]["outs"]:
        raise SystemExit("the prefix cache changed the outputs")
    _common.write_out(args.out, {
        "device": label, "rows": rows,
        "prefix": {k: {f: v for f, v in r.items() if f != "outs"}
                   for k, r in prefix.items()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
