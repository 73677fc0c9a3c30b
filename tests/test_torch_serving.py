"""PyTorch port: the fixed-slot continuous batcher against the JAX
package's, on the CPU, on the tiny LM of tests/test_paged.py (vocab 61,
d_model 64, 4 heads, 2 layers, max_len 48, sparsity 0.5, seed 0,
calibrated on 24 seeded tokens).  One JAX engine a configuration serves
every request of it; the port's runs its plain PyTorch path on CPU tensors.

Tolerances, each with its reason:
- Greedy streams and counters: equal, token for token, to the JAX engine's
  fed the same requests in the same order (the same scheduler, and the
  argmax of logits within 1e-4 of the JAX package's, tests/test_torch_lm.py)
  and to the port's own ``generate(parallel_prefill=False)`` (the same
  decode arithmetic, each row independent of the others in the batch).
- Sampled streams: equal, exactly, to the port's own ``sample`` with the
  same seed however requests interleave (one key a slot, split once a
  consumed token); torch cannot reproduce ``jax.random``'s streams, so
  against JAX they are not compared.
"""

import numpy as np
import pytest
import torch

from resnet_accel_tpu.models.lm import TransformerLMInt8 as JLM
from resnet_accel_tpu.runtime.serving import ContinuousBatcher as JCB
from resnet_accel_tpu_torch.models.lm import from_reference, prng_key
from resnet_accel_tpu_torch.runtime import ContinuousBatcher

torch.set_num_threads(1)

CFG = dict(seed=0, vocab=61, d_model=64, n_heads=4, n_layers=2, max_len=48,
           sparsity=0.5)


@pytest.fixture(scope="module")
def jlm():
    model = JLM.from_random(**CFG)
    scales = model.calibrate(np.random.default_rng(1).integers(0, 61, 24))
    return model, scales


@pytest.fixture(scope="module")
def lm(jlm):
    return from_reference(jlm[0])


def _requests(seed, n, lo=2, hi=9):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 61, rng.integers(lo, hi)).tolist(),
             int(rng.integers(3, 8))) for _ in range(n)]


def _drive(engine, script):
    """Run a script of ('submit', prompt, n_new, kw) and ('step', n) on an
    engine; returns the streams in submission order and the counters."""
    rids, res = [], {}
    for op in script:
        if op[0] == "submit":
            rids.append(engine.submit(op[1], op[2], **op[3]))
        else:
            for _ in range(op[1]):
                engine.step_engine()
            res.update(engine.results())
    res.update(engine.run())
    return [res[r] for r in rids], (engine.steps, engine.micro_steps)


def _script(reqs, mid=None):
    """Every request submitted up front, or the first ``mid`` of them, four
    steps, then the rest (mid-stream admission)."""
    head = reqs if mid is None else reqs[:mid]
    out = [("submit", p, n, kw) for p, n, kw in head]
    if mid is not None:
        out.append(("step", 4))
        out += [("submit", p, n, kw) for p, n, kw in reqs[mid:]]
    return out


SCRIPTS = {
    "interleaved": _script([(p, n, {}) for p, n in _requests(3, 5)]),
    "mid_stream": _script([([7, 7, 7], 10, {}), ([1, 2], 5, {}),
                           ([9, 8, 7, 6, 5], 6, {})], mid=1),
    "eos": _script([([5, 9, 2, 44], 8, dict(eos=None)),
                    ([5, 9, 2, 44], 8, dict(eos=37)),
                    ([3, 1, 4], 12, dict(eos=4))]),
}


@pytest.fixture(scope="module", params=[1, 4])
def jax_runs(request, jlm):
    """One JAX engine a chunk size drives every script in turn: {script:
    (streams, counters)}, the counters as the script's own increments."""
    model, scales = jlm
    eng = JCB(model, scales, slots=2, chunk=request.param)
    runs = {}
    for name in sorted(SCRIPTS):
        before = (eng.steps, eng.micro_steps)
        streams, after = _drive(eng, SCRIPTS[name])
        runs[name] = streams, tuple(a - b for a, b in zip(after, before))
    return request.param, runs


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_greedy_streams_equal_jax_and_generate(lm, jlm, jax_runs, name):
    _, scales = jlm
    chunk, runs = jax_runs
    script = SCRIPTS[name]
    got, counters = _drive(ContinuousBatcher(lm, scales, slots=2,
                                             chunk=chunk, device="cpu"),
                           script)
    assert (got, counters) == runs[name]
    for op, stream in zip([o for o in script if o[0] == "submit"], got):
        full = lm.generate(op[1], op[2], scales, parallel_prefill=False,
                           device="cpu").tolist()
        eos = op[3].get("eos")
        cut = full.index(eos) + 1 if eos in full else len(full)
        assert stream == full[:cut]


def test_eos_script_stops_early(lm, jlm):
    _, scales = jlm
    got, _ = _drive(ContinuousBatcher(lm, scales, slots=2, device="cpu"),
                    SCRIPTS["eos"])
    assert got[1] == got[0][:2] and got[1][-1] == 37
    assert got[2] == [4]


@pytest.mark.parametrize("slots,chunk", [(1, 1), (2, 3), (3, 4)])
def test_sampled_streams_equal_sample(lm, jlm, slots, chunk):
    _, scales = jlm
    reqs = [([3, 1, 4], 9, 7), ([9, 9], 6, 11), ([2, 7, 1, 8, 2], 8, 13),
            ([5], 7, 17)]
    eng = ContinuousBatcher(lm, scales, slots=slots, chunk=chunk,
                            temperature=3.0, top_k=12, device="cpu")
    rids = [eng.submit(p, n, seed=s) for p, n, s in reqs]
    res = eng.run()
    streams = set()
    for (p, n, s), rid in zip(reqs, rids):
        want = lm.sample(p, n, scales, prng_key(s), temperature=3.0,
                         top_k=12, device="cpu").tolist()
        assert res[rid] == want, rid
        streams.add(tuple(want))
    assert len(streams) == len(reqs)


def test_idle_slot_positions_stay_bounded(lm, jlm):
    _, scales = jlm
    eng = ContinuousBatcher(lm, scales, slots=3, chunk=4, device="cpu")
    eng.submit([1, 2, 3], 30)
    for _ in range(3):
        eng.step_engine()
    assert eng._lens.tolist() == [12, 0, 0]


@pytest.mark.parametrize("kw,match", [
    (dict(slots=0), "slots"), (dict(chunk=0), "chunk"),
    (dict(top_k=0), "top_k"), (dict(max_len=64), "position table")])
def test_constructor_errors_match_jax(lm, jlm, kw, match):
    model, scales = jlm
    with pytest.raises(ValueError, match=match) as jerr:
        JCB(model, scales, **kw)
    with pytest.raises(ValueError, match=match) as err:
        ContinuousBatcher(lm, scales, device="cpu", **kw)
    assert str(err.value) == str(jerr.value)


def test_submit_errors_match_jax(lm, jlm):
    model, scales = jlm
    for prompt, n_new in (([], 3), ([1] * 40, 10)):
        with pytest.raises(ValueError) as jerr:
            JCB(model, scales).submit(prompt, n_new)
        with pytest.raises(ValueError) as err:
            ContinuousBatcher(lm, scales, device="cpu").submit(prompt, n_new)
        assert str(err.value) == str(jerr.value)


def test_cuda_without_card_raises(lm, jlm):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        ContinuousBatcher(lm, jlm[1])
