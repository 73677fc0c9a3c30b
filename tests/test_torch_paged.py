"""PyTorch port: the paged-KV batcher against the JAX package's, on the CPU,
on the tiny LM of tests/test_paged.py (vocab 61, d_model 64, 4 heads, 2
layers, max_len 48, sparsity 0.5, seed 0, calibrated on 24 seeded tokens),
in each mode: full reservation, on-demand pages with preemption, the prefix
cache, int8 KV pages, speculation and adaptive speculation.  One JAX engine
a configuration serves every request of it; the port's runs its plain
PyTorch path on CPU tensors.

Tolerances, each with its reason:
- Greedy streams and the engines' counters (steps, micro-steps,
  preemptions, cache hits, tokens skipped, mode switches): equal to the JAX
  engine's fed the same requests (the same host scheduler, copied, and the
  argmax of logits within 1e-4 of the JAX package's), int8 KV included:
  both quantize each K/V row from the same values.  fp32 streams also equal
  the port's own ``generate(parallel_prefill=False)``.
- ``score()``: within 1e-4 of the JAX engine's log-probs, fp32 and int8 KV
  alike (the same int8 activations; float32 sums in another order, as in
  tests/test_torch_lm.py).  With int8 KV both sides quantize the same K/V
  rows, but each divides by its own float32 scale (XLA may multiply by the
  reciprocal), so a value on a rounding boundary could land one int8 step
  apart; on these sequences none does (max difference 7.6e-6, as with
  fp32).  The int8 engine is lossy by design: its distance from fp32 is
  held to tests/test_paged.py's bound, a mean shift under 0.05, and its
  greedy tokens to 90 % agreement with ``generate``.
- Sampled streams: equal, exactly, to the port's own ``sample`` with the
  same seed, through preemption and the prefix cache (one key a slot, split
  once a consumed token, saved across a preemption).
"""

import numpy as np
import pytest
import torch

from resnet_accel_tpu.models.lm import TransformerLMInt8 as JLM
from resnet_accel_tpu.runtime.paged import PagedKVBatcher as JPB
from resnet_accel_tpu_torch.models.lm import from_reference, prng_key
from resnet_accel_tpu_torch.runtime import PagedKVBatcher

torch.set_num_threads(1)

CFG = dict(seed=0, vocab=61, d_model=64, n_heads=4, n_layers=2, max_len=48,
           sparsity=0.5)
REPEAT = [7, 3, 9, 5, 7, 3, 9, 5, 7, 3, 9, 5]
SYS = list(range(1, 17))                 # two full pages at page 8


@pytest.fixture(scope="module")
def jlm():
    model = JLM.from_random(**CFG)
    scales = model.calibrate(np.random.default_rng(1).integers(0, 61, 24))
    return model, scales


@pytest.fixture(scope="module")
def lm(jlm):
    return from_reference(jlm[0])


def _requests(seed, n, lo=2, hi=9, n_lo=3, n_hi=8):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 61, rng.integers(lo, hi)).tolist(),
             int(rng.integers(n_lo, n_hi))) for _ in range(n)]


COUNTERS = ("steps", "micro_steps", "preemptions", "cache_hits",
            "cache_tokens_skipped", "spec_switches")

#: name -> (engine arguments, rounds of requests; each round is submitted
#: and drained before the next, so later rounds see the prefix cache)
MODES = {
    "full": (dict(slots=2, page=8, pool_pages=9),
             [_requests(3, 5) + [(REPEAT, 10)]]),
    "ondemand_preempt": (
        dict(slots=3, page=4, pool_pages=6, reserve="ondemand", chunk=4),
        [_requests(5, 6)]),
    "prefix_cache": (
        dict(slots=1, page=8, pool_pages=12, prefix_cache=True),
        [[(SYS + [21], 5)], [(SYS + [33, 7], 5)], [(SYS + [21], 5)]]),
    "prefix_cache_preempt": (
        dict(slots=4, page=8, pool_pages=7, reserve="ondemand",
             prefix_cache=True),
        [[(list(range(1, 10)) + [i], 8) for i in range(4)]]),
    "int8_kv": (dict(slots=2, page=8, pool_pages=9, kv_dtype="int8"),
                [[(np.random.default_rng(i).integers(0, 61, 6).tolist(), 6)
                  for i in range(4)]]),
    "spec_draft": (dict(slots=2, page=4, pool_pages=14, spec_draft=5),
                   [_requests(3, 5) + [(REPEAT, 12), (REPEAT * 2, 11)]]),
    "spec_adaptive": (
        dict(slots=2, page=8, pool_pages=12, spec_draft=3,
             spec_adaptive=True, spec_min_take=999.0, spec_probe=1,
             spec_reprobe=2),
        [[(np.random.default_rng(7).integers(0, 61, n).tolist(), 12)
          for n in (3, 9, 14)] + [(REPEAT, 12)]]),
}


def _serve(engine, rounds):
    out = []
    for reqs in rounds:
        rids = [engine.submit(p, n) for p, n in reqs]
        res = engine.run()
        out += [res[r] for r in rids]
    return out, {c: getattr(engine, c) for c in COUNTERS}


@pytest.fixture(scope="module", params=sorted(MODES))
def served(request, lm, jlm):
    """Both engines of one mode over the same rounds of requests."""
    model, scales = jlm
    kw, rounds = MODES[request.param]
    port = PagedKVBatcher(lm, scales, device="cpu", **kw)
    jax_ = JPB(model, scales, **kw)
    return (request.param, rounds, port, jax_, _serve(port, rounds),
            _serve(jax_, rounds))


def test_greedy_streams_and_counters_equal_jax(served):
    name, _, _, _, (got, counters), (want, jcounters) = served
    assert got == want
    assert counters == jcounters
    if name == "ondemand_preempt" or name == "prefix_cache_preempt":
        assert counters["preemptions"] >= 1
    if name.startswith("prefix_cache"):
        assert counters["cache_tokens_skipped"] > 0
    if name == "spec_adaptive":
        assert counters["spec_switches"] > 2
    if name == "spec_draft":
        # the repetitive prompts accept drafts: fewer passes than tokens
        assert counters["steps"] < sum(n for p, n in MODES[name][1][0])


def test_streams_equal_generate(served, lm, jlm):
    """fp32 streams equal ``generate``'s; int8 KV, lossy by design, agrees
    on at least 90 % of the tokens (tests/test_paged.py's bound)."""
    name, rounds, _, _, (got, _), _ = served
    reqs = [r for rnd in rounds for r in rnd]
    want = [lm.generate(p, n, jlm[1], parallel_prefill=False,
                        device="cpu").tolist() for p, n in reqs]
    if name != "int8_kv":
        assert got == want
        return
    match = sum(x == y for a, c in zip(got, want) for x, y in zip(a, c))
    assert match / sum(len(c) for c in want) >= 0.9


def test_pages_all_returned(served):
    _, _, port, jax_, _, _ = served
    assert port.free_pages() + len(port._cache) == port.pool_pages - 1
    assert port.free_pages() == jax_.free_pages()
    assert sorted(port._cache.values()) == sorted(jax_._cache.values())
    assert all(ref == 0 for ref in port._page_ref.values())


def test_int8_pool_bytes(lm, jlm):
    _, scales = jlm
    kw = dict(slots=2, page=8, pool_pages=9)
    fp = PagedKVBatcher(lm, scales, device="cpu", **kw)
    q8 = PagedKVBatcher(lm, scales, device="cpu", kv_dtype="int8", **kw)
    # [L, P, page, D] float32 against int8 values and a float32 scale a row
    assert fp.kv_pool_bytes() == 2 * 2 * 9 * 8 * 64 * 4
    assert q8.kv_pool_bytes() == 2 * 2 * 9 * 8 * (64 + 4)
    assert fp.kv_pool_bytes() / q8.kv_pool_bytes() > 3.5


def test_page_admission_control(lm, jlm):
    _, scales = jlm
    b = PagedKVBatcher(lm, scales, slots=2, page=8, pool_pages=4,
                       device="cpu")
    r1 = b.submit([1, 2, 3, 4, 5, 6], n_new=6)
    r2 = b.submit([6, 5, 4, 3, 2, 1], n_new=6)
    assert b.free_pages() == 3
    b.step_engine()
    assert len(b._active) == 1           # r2 waits for r1's pages
    res = b.run()
    assert b.free_pages() == 3
    for rid, p in ((r1, [1, 2, 3, 4, 5, 6]), (r2, [6, 5, 4, 3, 2, 1])):
        assert res[rid] == lm.generate(p, 6, scales, device="cpu").tolist()


def test_spec_eos_and_overhang(lm, jlm):
    _, scales = jlm
    ref = lm.generate(REPEAT, 16, scales, device="cpu").tolist()
    eos = ref[3]
    b = PagedKVBatcher(lm, scales, slots=1, page=8, pool_pages=12,
                       spec_draft=6, device="cpu")
    rid = b.submit(REPEAT, 16, eos=eos)
    assert b.run()[rid] == ref[:ref.index(eos) + 1]
    # prompt + n_new = max_len: the final windows write past it, into the
    # widened table's own pages
    b = PagedKVBatcher(lm, scales, slots=1, page=8, pool_pages=14,
                       max_pages=6, spec_draft=7, device="cpu")
    assert b._table_pages == 7
    rid = b.submit(REPEAT * 3, 12)
    assert b.run()[rid] == lm.generate(REPEAT * 3, 12, scales,
                                       device="cpu").tolist()


@pytest.mark.parametrize("kw", [
    dict(slots=2, page=8, pool_pages=9),
    dict(slots=2, page=4, pool_pages=8, reserve="ondemand", chunk=4),
    dict(slots=1, page=8, pool_pages=10, prefix_cache=True)])
def test_sampled_streams_equal_sample(lm, jlm, kw):
    _, scales = jlm
    b = PagedKVBatcher(lm, scales, temperature=3.0, top_k=8, device="cpu",
                       **kw)
    reqs = ([([3, 1, 4, 1, 5], 14, 7), ([2, 7, 1, 8], 14, 11)]
            if kw.get("reserve") else
            [(SYS[:9] + [2], 5, 13), (SYS[:9] + [2], 5, 13),
             ([9, 9], 4, 17)])
    rids = [b.submit(p, n, seed=s) for p, n, s in reqs]
    res = b.run()
    if kw.get("reserve"):
        assert b.preemptions >= 1
    if kw.get("prefix_cache"):
        assert b.cache_tokens_skipped >= 8
    for (p, n, s), rid in zip(reqs, rids):
        assert res[rid] == lm.sample(p, n, scales, prng_key(s),
                                     temperature=3.0, top_k=8,
                                     device="cpu").tolist(), rid


@pytest.mark.parametrize("kv_dtype,tol,seed,lengths", [
    ("fp32", 1e-4, 7, (17, 9, 30, 3, 2, 1, 0)),
    ("int8", 1e-4, 11, (33, 33, 33, 2, 1))])
def test_score_equals_jax(lm, jlm, kv_dtype, tol, seed, lengths):
    """The sequences of tests/test_paged.py's scoring tests, with the short
    and empty ones of its edge case."""
    model, scales = jlm
    kw = dict(slots=2, page=8, pool_pages=16, kv_dtype=kv_dtype)
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(0, 61, n).tolist() for n in lengths]
    port = PagedKVBatcher(lm, scales, device="cpu", **kw)
    got = port.score(seqs)
    want = JPB(model, scales, **kw).score(seqs)
    for g, w, seq in zip(got, want, seqs):
        assert g.dtype == np.float32 and g.shape == (max(len(seq) - 1, 0),)
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)
    assert port.free_pages() == port.pool_pages - 1
    if kv_dtype == "int8":
        fp = PagedKVBatcher(lm, scales, device="cpu", slots=2, page=8,
                            pool_pages=16).score(seqs)
        assert max(np.abs(a - c).mean() for a, c in zip(fp, got)
                   if len(a)) < 0.05
    # the engine serves again after scoring
    rid = port.submit(seqs[0][:6], 4)
    stream = port.run()[rid]
    if kv_dtype == "fp32":
        assert stream == lm.generate(seqs[0][:6], 4, scales,
                                     device="cpu").tolist()


def test_score_requires_idle_engine(lm, jlm):
    b = PagedKVBatcher(lm, jlm[1], slots=1, page=8, pool_pages=8,
                       device="cpu")
    b.submit([1, 2, 3], 4)
    with pytest.raises(RuntimeError, match="idle"):
        b.score([[1, 2, 3]])


@pytest.mark.parametrize("kw,match", [
    (dict(slots=0), "slots"), (dict(chunk=0), "chunk"),
    (dict(page=0), "page"), (dict(reserve="lazy"), "reserve"),
    (dict(spec_draft=-1), "spec_draft"),
    (dict(spec_draft=2, spec_ngram=0), "spec_ngram"),
    (dict(spec_adaptive=True), "spec_draft"),
    (dict(spec_draft=3, spec_adaptive=True, temperature=0.8), "greedy"),
    (dict(spec_draft=3, spec_adaptive=True, spec_probe=0), "spec_probe"),
    (dict(top_k=0), "top_k"), (dict(pool_pages=1), "2 pages"),
    (dict(kv_dtype="fp8"), "kv_dtype")])
def test_constructor_errors_match_jax(lm, jlm, kw, match):
    model, scales = jlm
    with pytest.raises(ValueError, match=match) as jerr:
        JPB(model, scales, **kw)
    with pytest.raises(ValueError, match=match) as err:
        PagedKVBatcher(lm, scales, device="cpu", **kw)
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("prompt,n_new,kw", [
    (list(range(1, 20)), 10, dict(slots=1, page=4, pool_pages=3,
                                  max_pages=10)),
    ([], 3, {}), ([1] * 40, 10, {})])
def test_submit_errors_match_jax(lm, jlm, prompt, n_new, kw):
    model, scales = jlm
    with pytest.raises(ValueError) as jerr:
        JPB(model, scales, **kw).submit(prompt, n_new)
    with pytest.raises(ValueError) as err:
        PagedKVBatcher(lm, scales, device="cpu", **kw).submit(prompt, n_new)
    assert str(err.value) == str(jerr.value)
