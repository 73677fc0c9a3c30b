"""PyTorch port: the LM measuring tools (``resnet_accel_tpu_torch/tools``)
against the JAX package's ``tools/`` on the CPU, at d_model 32, 2 heads,
one layer and sequences of 16, on a seeded byte corpus of random words
(repeated words give the prompt-lookup drafts something to find).

Tolerances, each with its reason:
- 0 (exact) for ``corpus_bytes``, ``batches``, the training windows,
  ``train_corpus_lm`` at 0 steps (the same numpy init, quantize and
  calibration), greedy tokens, verify passes, pools, ``kv_pool_bytes``,
  streams, agreements and first divergences and ``replay_acceptance``.
- The 3-step trajectory: loss history rtol 1e-4; each parameter by the
  share of its elements within atol 1e-5 + rtol 1e-4 (at least 0.999),
  none beyond 8 lr a step: tests/test_torch_train_lm.py's method (Adam
  turns rounding noise into steps of about lr).
- Float32 bits/byte: rtol 1e-5 (float32 sums in another order than
  XLA's).  INT8 bits/byte and the paged engine's scores: rtol 1e-4, and
  the int8-KV rows' delta and mean |dlogp| atol 2e-4 (the port's decode
  path sums in float64 and rounds once, JAX's in float32; an int8
  activation may round to a neighbour).
"""

import glob as globmod
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from resnet_accel_tpu.models import lm as JLM
from resnet_accel_tpu.train import lm as JT
from resnet_accel_tpu_torch.models.lm import from_reference
from resnet_accel_tpu_torch.models.sampling import prng_key
from resnet_accel_tpu_torch.models.transformer import PROJECTIONS
from resnet_accel_tpu_torch.tools import (kv8_quality, lm_corpus,
                                          lm_quality, paged_bench,
                                          paged_spec_bench, spec_bench)
from tools import kv8_quality as J_kv8
from tools import lm_corpus as J_corpus
from tools import lm_quality as J_quality
from tools import paged_bench as J_paged

torch.set_num_threads(2)

SMALL = dict(d_model=32, n_heads=2, n_layers=1)
SEQ, MAX_LEN = 16, 64


def _words_corpus(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    words = [rng.integers(0, 256, rng.integers(3, 9)) for _ in range(40)]
    out, size = [], 0
    while size < n:
        w = words[int(rng.integers(0, len(words)))]
        out.append(w)
        size += len(w)
    return np.concatenate(out)[:n].astype(np.int32)


CORPUS = _words_corpus(6000)


def _jax_params(seed=0, max_len=MAX_LEN):
    return JT.init_lm_fp32(vocab=256, d_model=32, n_heads=2, d_ff=64,
                           n_layers=1, max_len=max_len, seed=seed)


@pytest.fixture(scope="module")
def lms():
    """One LM of the tools' architecture in both packages: JAX's quantized
    model and scales, and the same carried over."""
    jm = JT.quantize_lm(_jax_params(seed=3), 2, block=8)
    jscales = jm.calibrate(CORPUS[:MAX_LEN])
    return jm, jscales, from_reference(jm), jscales


# ------------------------------------------------------------ lm_corpus

def test_corpus_bytes_equals_jax_on_a_tree(tmp_path, monkeypatch):
    """The JAX tool's two globs pointed at a temp tree of 45 .py files
    (past its cap of 40 a glob) and 3 .md files, nested."""
    rng = np.random.default_rng(1)
    for i in range(45):
        d = tmp_path / f"d{i % 3}" / ("deep" if i % 2 else "")
        d.mkdir(parents=True, exist_ok=True)
        (d / f"f{i:02d}.py").write_bytes(rng.bytes(int(rng.integers(1, 99))))
    for i in range(3):
        (tmp_path / f"n{i}.md").write_bytes(rng.bytes(50))

    def fake_glob(pattern, recursive=False):
        return globmod.glob(os.path.join(str(tmp_path), "**",
                                         os.path.basename(pattern)),
                            recursive=recursive)
    monkeypatch.setattr(J_corpus, "glob", types.SimpleNamespace(
        glob=fake_glob))
    want = J_corpus.corpus_bytes()
    got = lm_corpus.corpus_bytes(("**/*.md", "**/*.py"),
                                 max_files_per_glob=40, root=str(tmp_path))
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want) and len(got) > 2000
    assert len(lm_corpus.corpus_files(("**/*.py",), None,
                                      str(tmp_path))) == 45


def test_frozen_corpus_is_the_jax_package_text():
    files = lm_corpus.corpus_files()
    rel = [os.path.relpath(f, lm_corpus.REPO) for f in files]
    assert len(rel) > 100
    assert not any(os.path.basename(r).startswith("test_torch_")
                   for r in rel)
    assert not any(r.startswith("resnet_accel_tpu_torch") for r in rel)
    assert "tests/test_resnet18.py" in rel and "tools/lm_corpus.py" in rel
    corpus = lm_corpus.corpus_bytes()
    assert len(corpus) > 1_000_000 and corpus.max() < 256
    assert "sha256" in lm_corpus.describe(corpus)


def test_train_corpus_lm_zero_steps_bit_for_bit():
    """At 0 steps the port's train_corpus_lm is init, quantize with 8 x 8
    blocks and calibration on the first max_len bytes: JAX's pieces, bit
    for bit.  (JAX's train_corpus_lm cannot run 0 steps: it formats the
    final loss, which is None.)"""
    with pytest.raises(TypeError):
        J_corpus.train_corpus_lm(CORPUS, max_len=MAX_LEN, seq=SEQ, steps=0,
                                 **SMALL)
    model, scales, held = lm_corpus.train_corpus_lm(
        CORPUS, max_len=MAX_LEN, seq=SEQ, steps=0, holdout_frac=0.1,
        device="cpu", **SMALL)
    n_hold = int(len(CORPUS) * 0.1)
    assert np.array_equal(held, CORPUS[len(CORPUS) - n_hold:])
    jm = JT.quantize_lm(_jax_params(), 2, block=8)
    jscales = jm.calibrate(CORPUS[:MAX_LEN])
    ref = from_reference(jm)
    for f in ("embed", "pos", "lnf_g", "lnf_b"):
        assert np.array_equal(getattr(model, f), getattr(ref, f)), f
    for a, b in zip(model.blocks, ref.blocks):
        for name in PROJECTIONS:
            pa, pb = getattr(a, name), getattr(b, name)
            for g in ("data", "row_ptr", "col_idx"):
                assert np.array_equal(getattr(pa.bsr, g),
                                      getattr(pb.bsr, g)), (name, g)
            assert np.array_equal(pa.scales, pb.scales)
            assert np.array_equal(pa.bias, pb.bias)
    assert len(scales) == len(jscales)
    for s, j in zip(scales, jscales):
        assert s.keys() == j.keys()
        assert all(np.float32(s[k]) == np.float32(j[k]) for k in s)


def _jax_corpus_training(corpus, steps, seq, batch, lr, seed):
    """tools/lm_corpus.py's training loop, line for line, returning what
    the JAX function does not: the windows, the losses and the parameters.
    """
    n_layers, n_heads = SMALL["n_layers"], SMALL["n_heads"]
    params = _jax_params(seed=seed)
    train_keys = [k for k in params if k not in ("meta", "pos")]
    pj = {k: jnp.asarray(v) for k, v in params.items() if k != "meta"}
    opt = optax.adam(lr)

    def loss_fn(tp, toks):
        full = dict(pj)
        full.update(tp)
        logits = jax.vmap(
            lambda t: JT.lm_forward_fp32(full, t, n_layers, n_heads))(toks)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1], toks[:, 1:]).mean()

    @jax.jit
    def step(tp, state, toks):
        loss, g = jax.value_and_grad(loss_fn)(tp, toks)
        upd, state = opt.update(g, state)
        return optax.apply_updates(tp, upd), state, loss

    tp = {k: pj[k] for k in train_keys}
    state = opt.init(tp)
    rng = np.random.default_rng(seed)
    windows, losses = [], []
    for _ in range(steps):
        starts = rng.integers(0, len(corpus) - seq - 1, batch)
        windows.append(np.stack([corpus[o:o + seq] for o in starts]))
        tp, state, loss = step(tp, state, jnp.asarray(windows[-1]))
        losses.append(float(loss))
    for k in train_keys:
        params[k] = np.asarray(tp[k])
    return params, windows, losses


def test_train_corpus_lm_three_steps_trajectory():
    lr, steps, batch = 3e-3, 3, 4
    want, jwin, jhist = _jax_corpus_training(CORPUS, steps, SEQ, batch, lr,
                                             seed=0)
    # the copy is JAX's train_corpus_lm: its quantized model equals the
    # function's
    jm, jsc, _ = J_corpus.train_corpus_lm(CORPUS, max_len=MAX_LEN, seq=SEQ,
                                          steps=steps, batch=batch, lr=lr,
                                          **SMALL)
    copy = JT.quantize_lm(want, 2, block=8)
    for a, b in zip(jm.blocks, copy.blocks):
        for name in PROJECTIONS:
            assert np.array_equal(np.asarray(getattr(a, name).bsr.data),
                                  np.asarray(getattr(b, name).bsr.data))
    windows = []
    got, ghist, train, held, _ = lm_corpus.train_corpus_params(
        CORPUS, max_len=MAX_LEN, seq=SEQ, steps=steps, batch=batch, lr=lr,
        device="cpu", windows=windows, **SMALL)
    assert len(held) == 0 and np.array_equal(train, CORPUS)
    assert len(windows) == steps
    for a, b in zip(windows, jwin):
        assert np.array_equal(a, b)
    np.testing.assert_allclose(ghist, jhist, rtol=1e-4)
    assert list(got) == list(want)
    for k in ("pos", "meta"):
        assert np.array_equal(got[k], want[k])
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        d = np.abs(a - b)
        ok = float(np.mean(d <= 1e-5 + 1e-4 * np.abs(b)))
        assert d.max() <= 8 * lr * steps, k
        if not k.endswith(".wk_b"):
            assert ok >= 0.999, (k, ok)


# ----------------------------------------------------------- lm_quality

def test_lm_quality_batches_bit_for_bit():
    r1, r2 = np.random.default_rng(7), np.random.default_rng(7)
    for batch, seq in ((4, 16), (32, 128), (1, 5)):
        assert np.array_equal(lm_quality.batches(CORPUS, r1, batch, seq),
                              J_quality.batches(CORPUS, r2, batch, seq))


def test_lm_quality_bits_per_byte(lms):
    p = _jax_params(seed=5, max_len=SEQ)
    held = CORPUS[-2100:]
    want = J_quality.bits_per_byte_fp32(p, held, 1, 2, seq=SEQ, limit=2000)
    got = lm_quality.bits_per_byte_fp32(p, held, 1, 2, seq=SEQ, limit=2000,
                                        device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-5)
    jm, jscales, pm, pscales = lms
    want = J_quality.bits_per_byte_int8(jm, jscales, held, seq=SEQ,
                                        limit=2000)
    got = lm_quality.bits_per_byte_int8(pm, pscales, held, seq=SEQ,
                                        limit=2000, device="cpu")
    assert np.isfinite(got) and got > 1.0
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_lm_quality_run_end_to_end():
    """The whole flow at a tiny size: the gate keeps a snapshot, the masks
    keep the pruned blocks at 0, the INT8 model holds the pruned blocks
    only."""
    train, held = CORPUS[:5400], CORPUS[5400:]
    res = lm_quality.run(train, held, steps=4, ft_steps=(2, 2, 3),
                         val_every=2, ft_val_every=3, gate_limit=600,
                         seq=SEQ, batch=4, device="cpu", **SMALL)
    for k in ("fp32_bpb", "fp32_pruned_ft_bpb", "int8_sparse_bpb"):
        assert np.isfinite(res[k]) and res[k] > 1.0, k
    # 80 % of each projection's 8 x 8 blocks, rounded down: 12 of 16, 25
    # of 32
    assert res["mean_block_sparsity"] == pytest.approx((4 * 12 / 16
                                                        + 2 * 25 / 32) / 6)
    assert res["dense_steps"] == 4 and res["ft_steps"] == [2, 2, 3]


# ----------------------------------------------------------- kv8_quality

def _jax_ppl_row(mk, heldout, ctx, rng, n_windows):
    """tools/kv8_quality.py's part 1, one ctx, on its engines()."""
    offs = rng.integers(0, len(heldout) - ctx - 1, n_windows)
    seqs = [heldout[o:o + ctx].tolist() for o in offs]
    cat_fp = np.concatenate(mk("fp32").score(seqs))
    cat_q8 = np.concatenate(mk("int8").score(seqs))
    bpb_fp = float(-cat_fp.mean() / np.log(2))
    bpb_q8 = float(-cat_q8.mean() / np.log(2))
    return {"bpb_fp32_kv": bpb_fp, "bpb_int8_kv": bpb_q8,
            "delta_bpb": bpb_q8 - bpb_fp,
            "mean_abs_dlogp": float(np.abs(cat_fp - cat_q8).mean())}


def _jax_greedy(mk, heldout, rng, prompt, new):
    """tools/kv8_quality.py's part 2."""
    offs = rng.integers(0, len(heldout) - prompt - 1, 4)
    prompts = [heldout[o:o + prompt].tolist() for o in offs]
    e_fp, e_q8 = mk("fp32"), mk("int8")
    r_fp = [e_fp.submit(p, new) for p in prompts]
    r_q8 = [e_q8.submit(p, new) for p in prompts]
    o_fp, o_q8 = e_fp.run(), e_q8.run()
    agree, total, first_div = 0, 0, []
    for a, b in zip(r_fp, r_q8):
        same = [x == y for x, y in zip(o_fp[a], o_q8[b])]
        agree += sum(same)
        total += len(same)
        first_div.append(same.index(False) if False in same else len(same))
    return agree / total, first_div


def test_kv8_rows_and_greedy_against_jax_engines(lms):
    jm, jscales, pm, pscales = lms
    heldout = CORPUS[-800:]
    jmk = J_kv8.engines(jm, jscales)
    pmk = kv8_quality.engines(pm, pscales, device="cpu")
    jrng, prng = np.random.default_rng(0), np.random.default_rng(0)
    for ctx in (24, 48):
        want = _jax_ppl_row(jmk, heldout, ctx, jrng, 3)
        got = kv8_quality.ppl_row(pmk, heldout, ctx, prng, 3)
        assert got["ctx"] == ctx and got["tokens"] == 3 * (ctx - 1)
        for k in ("bpb_fp32_kv", "bpb_int8_kv"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       err_msg=k)
        for k in ("delta_bpb", "mean_abs_dlogp"):
            np.testing.assert_allclose(got[k], want[k], atol=2e-4,
                                       err_msg=k)
    agreement, first_div = _jax_greedy(jmk, heldout, jrng, 24, 8)
    got = kv8_quality.greedy_agreement(pmk, heldout, prng, 24, 8)
    assert got["agreement"] == agreement
    assert got["first_divergence"] == first_div


def test_kv8_sampled_streams_reseeded(lms):
    """Part 3 on the port's keys: each stream seeded 1000 + s, so a rerun
    gives the same streams."""
    _, _, pm, pscales = lms
    heldout = CORPUS[-800:]
    mk = kv8_quality.engines(pm, pscales, device="cpu")
    a = kv8_quality.sampled_agreement(mk, heldout, np.random.default_rng(2),
                                      seeds=2, prompt=16, new=6)
    b = kv8_quality.sampled_agreement(mk, heldout, np.random.default_rng(2),
                                      seeds=2, prompt=16, new=6)
    assert a == b and a["tokens"] == 12 and len(a["first_divergence"]) == 2


# ------------------------------------------------------------ spec_bench

def test_spec_bench_tokens_and_passes_equal_jax(lms):
    jm, jscales, pm, pscales = lms
    prompts = spec_bench.corpus_prompts(CORPUS, prompt=24,
                                        offsets=(100, 3000))
    res = spec_bench.run(pm, pscales, prompts, n_new=12, draft=4, ngram=2,
                         device="cpu", label="cpu")
    assert res["draft"] == 4 and len(res["prompts"]) == 2
    for p, row in zip(prompts, res["prompts"]):
        toks, passes = jm.generate_speculative(
            jnp.asarray(p), 12, jscales, draft=4, ngram=2,
            return_stats=True)
        assert row["speculative"] == np.asarray(toks).tolist()
        assert row["vanilla"] == np.asarray(toks).tolist()
        assert row["passes"] == int(passes) and row["same"]


def test_spec_bench_sampled_first_token_parity(lms):
    _, _, pm, pscales = lms
    prompt = CORPUS[100:124]
    r = spec_bench.bench_prompt(pm, pscales, prompt, 0, n_new=8, draft=3,
                                temperature=0.8, device="cpu")
    assert r["check"] == "tok0-parity" and r["same"]
    assert np.array_equal(r["vanilla"], pm.sample(
        prompt, 8, pscales, prng_key(0), temperature=0.8, device="cpu"))


# ----------------------------------------------------------- paged_bench

@pytest.fixture
def small_jax_random_lm(monkeypatch):
    """JAX's paged_bench builds its own d256 4-layer LM: shrink it to the
    tools' test size (the port's measure takes the size as an argument)."""
    orig = JLM.TransformerLMInt8.from_random
    monkeypatch.setattr(JLM.TransformerLMInt8, "from_random", classmethod(
        lambda cls, **kw: orig(**dict(kw, **SMALL))))


@pytest.mark.parametrize("kv,oversub,reserve", [("fp32", 1.0, "full"),
                                                ("int8", 1.67, "ondemand")])
def test_paged_bench_measure_equals_jax(small_jax_random_lm, kv, oversub,
                                        reserve):
    args = (32, 10, 5)
    kw = dict(slots=2, page=8, chunk=4, oversub=oversub, reserve=reserve,
              kv_dtype=kv)
    _, _, jpool, jmb, jfixed, jouts = J_paged.measure(*args, **kw)
    _, _, pool, mb, fixed, outs = paged_bench.measure(
        *args, **kw, device="cpu", model_kw=SMALL)
    assert (pool, mb, fixed) == (jpool, jmb, jfixed)
    assert outs == jouts and all(len(o) == 5 for o in outs)


def test_paged_bench_prefix_skips_as_jax(small_jax_random_lm):
    kw = dict(max_len=64, sys_len=16, uniq=4, n_new=4, slots=2, page=8,
              chunk=4)
    skipped = {}
    for cache in (False, True):
        _, _, want = J_paged.measure_prefix(**kw, cache=cache)
        _, _, got, outs = paged_bench.measure_prefix(
            **kw, cache=cache, device="cpu", model_kw=SMALL)
        assert got == want
        skipped[cache] = (got, outs)
    assert skipped[False][0] == 0 and skipped[True][0] > 0
    assert skipped[False][1] == skipped[True][1]


# ------------------------------------------------------ paged_spec_bench

def _jax_replay_acceptance(prompts, streams, draft, ngram=3):
    """tools/paged_spec_bench.py's replay_acceptance, on JAX's _draft."""
    from resnet_accel_tpu.runtime.paged import PagedKVBatcher as JB
    emitted = verifies = 0
    for p, s in zip(prompts, streams):
        chain, pos = list(p) + list(s), len(p)
        while pos < len(chain):
            d = JB._draft(type("D", (), {"spec_ngram": ngram})(),
                          chain[:pos], draft)
            k = 0
            while (k < len(d) and pos + k + 1 < len(chain)
                   and d[k] == chain[pos + k]):
                k += 1
            step = min(k + 1, len(chain) - pos)
            emitted += step
            verifies += 1
            pos += step
    return emitted / max(verifies, 1)


@pytest.mark.parametrize("draft,ngram", [(3, 2), (7, 3), (15, 3), (1, 1)])
def test_replay_acceptance_equals_jax(draft, ngram):
    prompts = [CORPUS[o:o + 40].tolist() for o in (0, 500, 2000)]
    streams = [CORPUS[o + 40:o + 90].tolist() for o in (0, 500, 2000)]
    streams.append(list(range(20)))
    prompts.append([5, 6, 7] * 10)
    got = paged_spec_bench.replay_acceptance(prompts, streams, draft, ngram)
    assert got == _jax_replay_acceptance(prompts, streams, draft, ngram)
    assert got >= 1.0


def test_paged_spec_grid_streams_identical(lms):
    """Drafts 0 and 3 at 2 slots, float32 and int8 KV: every speculative
    stream equals the draft-0 engine's, and draft 0 equals the JAX engine."""
    jm, jscales, pm, pscales = lms
    rows = paged_spec_bench.grid(pm, pscales, CORPUS, drafts=(0, 3),
                                 slot_counts=(2,), prompt=24, n_new=8,
                                 device="cpu", label="cpu")
    assert [(r["kv"], r["draft"]) for r in rows] == [
        ("fp32", 0), ("fp32", 3), ("int8", 0), ("int8", 3)]
    assert all(r["identical"] for r in rows)
    prompts = paged_spec_bench.slot_prompts(CORPUS, 2, 24)
    _, _, streams = paged_spec_bench.run_engine(pm, pscales, 2, 0, prompts,
                                                24, 8, device="cpu")
    from resnet_accel_tpu.runtime.paged import PagedKVBatcher as JB
    jb = JB(jm, jscales, slots=2, page=16, pool_pages=2 * 2 + 2, chunk=8)
    rids = [jb.submit(p, 8) for p in prompts]
    out = jb.run()
    assert streams == [tuple(out[r]) for r in rids]
