"""PyTorch port: temperature and top-k sampling, the port's random streams,
the verify pass and speculative decoding, against the JAX package's, on the
CPU, on the tiny LM of tests/test_paged.py (vocab 61, d_model 64, 4 heads,
2 layers, max_len 48, sparsity 0.5, seed 0, calibrated on 24 seeded
tokens).  The JAX side runs ``flash=False``; the port, on CPU tensors, its
plain versions.

Tolerances, each with its reason:
- Greedy tokens and verify-pass counts: equal.  Greedy acceptance keeps the
  model's argmax chain, so the tokens are ``generate``'s and the passes
  depend only on the tokens and the prompt-lookup rule, which is copied.
- ``adjust_logits``: bit for bit (the same float32 division by the
  temperature rounded once to float32, and the same keep-ties rule).
- Verify-pass logits: rtol = atol = 1e-4 against the JAX package's (the
  same int8 activations; float32 LayerNorm, softmax and readout summed in
  another order; tests/test_torch_lm.py holds decode to the same), and bit
  for bit against the port's own decode steps (every reduction in float64,
  rounded once: a row does not depend on how many rows go with it).
- Sampled tokens: torch cannot reproduce ``jax.random``'s streams, so the
  port's draws are held to the exact softmax in distribution: each
  frequency over N vectorized draws within 4 binomial standard deviations
  plus 1e-4 (the bound tests/test_spec_sampling.py uses), and the port's
  own streams are deterministic for a key and equal across its paths.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from resnet_accel_tpu.models.lm import TransformerLMInt8 as JLM
from resnet_accel_tpu.models.lm import adjust_logits as j_adjust_logits
from resnet_accel_tpu_torch.models.lm import from_reference
from resnet_accel_tpu_torch.models.sampling import (
    adjust_logits,
    categorical,
    greedy_accept,
    prng_key,
    sampled_token,
    spec_accept_sampled,
    split,
    uniform,
)

torch.set_num_threads(1)

CFG = dict(seed=0, vocab=61, d_model=64, n_heads=4, n_layers=2, max_len=48,
           sparsity=0.5)
REPEAT = [7, 3, 9, 5, 7, 3, 9, 5, 7, 3, 9, 5]
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def jlm():
    model = JLM.from_random(**CFG)
    scales = model.calibrate(np.random.default_rng(1).integers(0, 61, 24))
    return model, scales


@pytest.fixture(scope="module")
def lm(jlm):
    return from_reference(jlm[0])


@pytest.fixture(scope="module")
def mod(lm):
    return lm.module("cpu")


def _within_4_sigma(counts, p, n):
    tol = 4 * np.sqrt(p * (1 - p) / n) + 1e-4
    return np.all(np.abs(counts - p) < tol), (counts, p)


# ------------------------------------------------------------ the streams

def test_keys_are_deterministic_and_distinct():
    a, b = prng_key(7), prng_key(7)
    assert a.dtype == torch.int64 and a.shape == (2,)
    assert torch.equal(a, b) and not torch.equal(a, prng_key(8))
    kids = split(a, 1000)
    assert kids.shape == (1000, 2)
    assert len({tuple(k) for k in kids.tolist()}) == 1000
    assert int(kids.max()) < 2 ** 32 and int(kids.min()) >= 0
    assert torch.equal(split(kids[:3]), torch.stack([split(k)
                                                     for k in kids[:3]]))
    # seeds past 32 bits and negative seeds are keys of their own
    assert len({tuple(prng_key(s).tolist())
                for s in (0, 1, 2 ** 32, -1, 2 ** 40 + 1)}) == 5


def test_uniform_open_interval_and_moments():
    u = uniform(split(prng_key(3), 64), 4096).double()
    assert u.shape == (64, 4096)
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0
    n = u.numel()
    assert abs(float(u.mean()) - 0.5) < 4 * np.sqrt(1 / 12 / n)
    hist = torch.histc(u, bins=16, min=0, max=1).numpy() / n
    ok, info = _within_4_sigma(hist, np.full(16, 1 / 16), n)
    assert ok, info


def test_categorical_marginal_is_softmax():
    z = torch.tensor(np.random.default_rng(2).normal(0, 1.5, 12),
                     dtype=torch.float32)
    z[3] = float("-inf")
    N = 60000
    draws = categorical(split(prng_key(0), N), z.expand(N, -1)).numpy()
    p = torch.softmax(z.double(), 0).numpy()
    assert (draws != 3).all()
    ok, info = _within_4_sigma(np.bincount(draws, minlength=12) / N, p, N)
    assert ok, info


# --------------------------------------------------------- adjust_logits

@pytest.mark.parametrize("temperature,top_k", [
    (0.7, None), (0.7, 3), (1.3, 1), (0.9, 8), (2.0, 61), (0.8, 60)])
def test_adjust_logits_equals_jax_bit_for_bit(temperature, top_k):
    rng = np.random.default_rng(5)
    logits = rng.normal(0, 2, (4, 61)).astype(np.float32)
    # ties at the k-th value: rows 2 and 3 repeat their k-th largest
    logits[2] = np.round(logits[2])
    logits[3, :6] = logits[3].max()
    got = adjust_logits(torch.from_numpy(logits), temperature, top_k)
    want = np.asarray(j_adjust_logits(jnp.asarray(logits), temperature,
                                      top_k))
    np.testing.assert_array_equal(got.numpy(), want)


def test_adjust_logits_keeps_ties_at_the_kth_value():
    z = torch.tensor([1.0, 3.0, 2.0, 3.0, 2.0, 0.0])
    kept = torch.isfinite(adjust_logits(z, 1.0, top_k=3))
    # the k-th value is 2.0, held twice: four values survive
    assert kept.tolist() == [False, True, True, True, True, False]


def test_sampled_token_marginal_and_split():
    logits = torch.tensor(np.random.default_rng(4).normal(0, 2, 10),
                          dtype=torch.float32)
    N = 60000
    keys = split(prng_key(9), N)
    k2, toks = sampled_token(logits.expand(N, -1), keys, 0.7, top_k=4)
    assert torch.equal(k2, split(keys)[:, 0])
    p = torch.softmax(adjust_logits(logits, 0.7, 4).double(), 0).numpy()
    counts = np.bincount(toks.numpy(), minlength=10) / N
    assert (counts[p == 0] == 0).all()
    ok, info = _within_4_sigma(counts, p, N)
    assert ok, info


# ---------------------------------------------------- spec_accept_sampled

class TestSpecAcceptMath:
    """The port's accept/emit step against the exact sequential-sampling
    distribution, as tests/test_spec_sampling.py holds the JAX one."""

    S, V, N = 4, 8, 60000

    @pytest.fixture(scope="class")
    def mc(self):
        rng = np.random.default_rng(11)
        z = torch.tensor(rng.normal(0, 1.5, (self.S, self.V)),
                         dtype=torch.float32)
        fed = torch.tensor(rng.integers(0, self.V, self.S))
        keys = split(prng_key(0), self.N)
        n_acc, emit, k2 = spec_accept_sampled(
            z.expand(self.N, -1, -1), fed.expand(self.N, -1), keys)
        assert torch.equal(k2, split(keys, 3)[:, 0])
        return z.numpy(), fed.numpy(), n_acc.numpy(), emit.numpy()

    @staticmethod
    def _p(row):
        e = np.exp(row - row.max())
        return e / e.sum()

    def test_first_emitted_token_marginal_is_target(self, mc):
        z, fed, n_acc, emit = mc
        ok, info = _within_4_sigma(
            np.bincount(emit[:, 0], minlength=self.V) / self.N,
            self._p(z[0]), self.N)
        assert ok, info

    def test_second_token_conditional_is_target(self, mc):
        z, fed, n_acc, emit = mc
        sel = emit[:, 0] == fed[1]
        assert sel.sum() > 3000
        ok, info = _within_4_sigma(
            np.bincount(emit[sel, 1], minlength=self.V) / sel.sum(),
            self._p(z[1]), sel.sum())
        assert ok, info

    def test_acceptance_rate_matches_p_draft(self, mc):
        z, fed, n_acc, emit = mc
        exp = self._p(z[0])[fed[1]]
        rate = (n_acc >= 1).mean()
        assert abs(rate - exp) < 4 * np.sqrt(exp * (1 - exp) / self.N)

    def test_rejection_never_emits_the_draft(self, mc):
        z, fed, n_acc, emit = mc
        rej = emit[:, 0] != fed[1]
        assert rej.any() and (n_acc[rej] == 0).all()

    def test_emit_prefix_is_the_draft_chain(self, mc):
        z, fed, n_acc, emit = mc
        for i in range(self.S - 1):
            sel = n_acc > i
            assert sel.any()
            assert (emit[sel, i] == fed[i + 1]).all()

    def test_certain_draft_always_accepted(self):
        z = torch.full((256, 2, self.V), -30.0)
        z[:, 0, 3] = 0.0
        z[:, 1, 5] = 0.0
        fed = torch.tensor([0, 3]).expand(256, -1)
        n_acc, emit, _ = spec_accept_sampled(z, fed, split(prng_key(1),
                                                           256))
        assert (n_acc == 1).all()
        assert (emit[:, 0] == 3).all() and (emit[:, 1] == 5).all()

    def test_known_tokens_always_accepted(self):
        # n_known forces the leading rows whatever the draw; per slot
        z = torch.full((3, 4, self.V), -30.0)
        z[..., 0] = 0.0                   # the target never picks the drafts
        fed = torch.tensor([1, 2, 3, 4]).expand(3, -1)
        n_acc, _, _ = spec_accept_sampled(z, fed, split(prng_key(2), 3),
                                          n_known=torch.tensor([1, 3, 4]))
        assert n_acc.tolist() == [0, 2, 3]
        n_acc, g = greedy_accept(z, fed, n_known=torch.tensor([1, 3, 4]))
        assert n_acc.tolist() == [0, 2, 3] and (g == 0).all()


# ---------------------------------------------------------- verify pass

def test_verify_step_matches_jax(mod, jlm):
    model, scales = jlm
    prompt = np.asarray(REPEAT, np.int32)
    fed = np.asarray([5, 7, 3, 9, 5, 1], np.int32)

    @jax.jit
    def j_verify(prompt, fed):
        x = jnp.asarray(model.embed)[prompt] + jnp.asarray(model.pos)[:12]
        jc = []
        for i, blk in enumerate(model.blocks):
            x, c = blk.prefill(x, scales[i], blk.init_cache(model.max_len))
            jc.append(c)
        return model.verify_step(jc, fed, scales)
    want, jc = j_verify(jnp.asarray(prompt), jnp.asarray(fed))
    _, caches = mod.prefill(prompt, scales)
    got, caches = mod.verify_step(caches, fed, scales)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert caches[0]["len"] == 18
    np.testing.assert_allclose(caches[1]["k"].numpy(),
                               np.asarray(jc[1]["k"]), **TOL)


def test_verify_rows_equal_decode_steps_bit_for_bit(mod, jlm):
    """Each row of a verify pass is what one decode step computes, bit for
    bit, and a slot of a batch what a lone sequence computes."""
    _, scales = jlm
    prompt = np.asarray(REPEAT, np.int32)
    fed = [5, 7, 3, 9, 5, 1]
    _, caches = mod.prefill(prompt, scales)
    rows, _ = mod.verify_step(caches, fed, scales)
    _, caches = mod.prefill(prompt, scales)
    for i, t in enumerate(fed):
        logits, caches = mod.decode_step(caches, t, scales)
        assert torch.equal(logits, rows[i]), i
    # per-slot positions: three sequences at positions 3, 7 and 12
    lens = torch.tensor([3, 7, 12])
    batch = mod.init_caches(lead=(3,))
    for t in range(12):
        _, batch = mod.decode_step(
            [dict(c, len=torch.full((3,), t)) for c in batch],
            torch.tensor(REPEAT[t]).expand(3), scales)
    logits, batch = mod.decode_step([dict(c, len=lens) for c in batch],
                                    torch.tensor([5, 7, 3]), scales)
    assert torch.equal(batch[0]["len"], lens + 1)
    for b, n in enumerate(lens.tolist()):
        _, single = mod.prefill(prompt[:n], scales)
        want, _ = mod.decode_step(single, [5, 7, 3][b], scales)
        assert torch.equal(logits[b], want), b


# --------------------------------------------------- speculative decoding

@pytest.mark.parametrize("prompt,n_new,draft", [
    (REPEAT + [2, 8], 18, 15), ([5, 9, 2, 44, 17, 1] + REPEAT, 16, 3)])
def test_greedy_speculative_equals_jax(lm, jlm, prompt, n_new, draft):
    model, scales = jlm
    p = np.asarray(prompt, np.int32)
    got, passes = lm.generate_speculative(p, n_new, scales, draft=draft,
                                          return_stats=True, device="cpu")
    want, jpasses = model.generate_speculative(jnp.asarray(p), n_new,
                                               scales, draft=draft,
                                               return_stats=True)
    assert got.dtype == np.int32 and got.shape == (n_new,)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert passes == int(jpasses)
    np.testing.assert_array_equal(got, lm.generate(p, n_new, scales,
                                                   device="cpu"))


def test_speculation_cuts_passes_on_repetitive_text(lm, jlm):
    _, scales = jlm
    toks, passes = lm.generate_speculative(np.asarray(REPEAT), 20, scales,
                                           draft=7, return_stats=True,
                                           device="cpu")
    assert passes < 19


@pytest.mark.parametrize("kw,match", [
    (dict(n_new=30, draft=15), "exceeds max_len"),
    (dict(n_new=4, ngram=0), "ngram"),
    (dict(n_new=4, temperature=1.0), "rng_key"),
    (dict(n_new=4, top_k=0), "top_k")])
def test_speculative_errors_match_jax(lm, jlm, kw, match):
    model, scales = jlm
    p = np.asarray(REPEAT, np.int32)
    kw = dict(kw)
    n_new = kw.pop("n_new")
    with pytest.raises(ValueError, match=match) as jerr:
        model.generate_speculative(p, n_new, scales, **kw)
    with pytest.raises(ValueError, match=match) as err:
        lm.generate_speculative(p, n_new, scales, device="cpu", **kw)
    assert str(err.value) == str(jerr.value)


def test_sampled_speculative_deterministic_and_key_sensitive(lm, jlm):
    _, scales = jlm
    p = np.asarray(REPEAT + [2], np.int32)

    def run(seed):
        return lm.generate_speculative(p, 20, scales, draft=7,
                                       temperature=4.0,
                                       rng_key=prng_key(seed), device="cpu")
    a, b, c = run(0), run(0), run(1)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.shape == (20,) and ((a >= 0) & (a < 61)).all()


def test_sampled_speculative_first_token_and_top1(lm, jlm):
    _, scales = jlm
    p = np.asarray(REPEAT + [2], np.int32)
    for seed in range(4):
        s = lm.sample(p, 3, scales, prng_key(seed), temperature=3.0,
                      device="cpu")
        g = lm.generate_speculative(p, 3, scales, draft=5, temperature=3.0,
                                    rng_key=prng_key(seed), device="cpu")
        assert s[0] == g[0]
    greedy = lm.generate(p, 20, scales, device="cpu")
    got = lm.generate_speculative(p, 20, scales, draft=7, temperature=1.0,
                                  top_k=1, rng_key=prng_key(3), device="cpu")
    np.testing.assert_array_equal(got, greedy)


def test_sampled_speculative_budget_clamp(lm, jlm):
    _, scales = jlm
    toks, passes = lm.generate_speculative(
        np.asarray(([1, 2, 3, 4, 5] * 4)[:18]), 7, scales, draft=15,
        temperature=0.8, rng_key=prng_key(2), return_stats=True,
        device="cpu")
    assert toks.shape == (7,) and passes >= 1


# ---------------------------------------------------------------- sample

def test_sample_greedy_and_top1_equal_generate(lm, jlm):
    _, scales = jlm
    p = np.asarray([5, 9, 2, 44], np.int32)
    greedy = lm.generate(p, 10, scales, device="cpu")
    np.testing.assert_array_equal(
        lm.sample(p, 10, scales, prng_key(0), temperature=0.0,
                  device="cpu"), greedy)
    np.testing.assert_array_equal(
        lm.sample(p, 10, scales, prng_key(0), temperature=5.0, top_k=1,
                  device="cpu"), greedy)


def test_sample_deterministic_per_key(lm, jlm):
    _, scales = jlm
    p = np.asarray([5, 9, 2, 44], np.int32)
    a = lm.sample(p, 16, scales, prng_key(4), temperature=3.0, top_k=20,
                  device="cpu")
    b = lm.sample(p, 16, scales, prng_key(4), temperature=3.0, top_k=20,
                  device="cpu")
    c = lm.sample(p, 16, scales, prng_key(5), temperature=3.0, top_k=20,
                  device="cpu")
    assert a.dtype == np.int32 and a.shape == (16,)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_sample_errors_match_jax(lm, jlm):
    model, scales = jlm
    p = np.asarray([1, 2, 3], np.int32)
    for n_new, kw, match in ((4, dict(top_k=0), "top_k"),
                             (46, {}, "exceeds max_len")):
        with pytest.raises(ValueError, match=match) as jerr:
            model.sample(p, n_new, scales, jax.random.PRNGKey(0), **kw)
        with pytest.raises(ValueError, match=match) as err:
            lm.sample(p, n_new, scales, prng_key(0), device="cpu", **kw)
        assert str(err.value) == str(jerr.value)
