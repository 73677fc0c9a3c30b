"""PyTorch port: head (tensor) parallelism -- the tp block forward, the
cached decode step, the LM's generate (and its dp x tp batched form), the
tp paged engine and ``serve --tp`` -- against the JAX package, on the CPU.

The port's side runs in ONE world of four gloo ranks (a module fixture);
tp 2 runs on a (dp 2, tp 2) mesh, so that both dp groups run it and every
rank's result is compared; tp 4 on a (tp 4) mesh.  The JAX side runs in
this process on the conftest's virtual CPU devices, at the JAX tests'
sizes (tests/test_heads_tp.py, tests/test_paged_tp.py).

Tolerances, each with its reason:
- The tp forward (dynamic scales): within 2e-5 of the JAX package's tp
  program and of the single-rank blocks, JAX's own bound for float32
  reassociation (every integer decision is exact).
- The cached decode step (static scales): the port's decode path sums in
  float64 and rounds once, so each step equals the port's single-rank
  ``decode_step`` (within 1e-6) and stays within the JAX test's bounds of
  the JAX block's step (cache 2e-5, output 1e-2: a 1e-7 float difference
  can flip one int8 activation).
- Tokens and streams: equal.  Greedy generate and the greedy paged streams
  equal the JAX package's tp programs' and the port's single-rank ones;
  sampled streams equal the port's single-rank engine's (torch cannot
  reproduce ``jax.random``); ``score()`` within 1e-5 of the single-rank
  engine (JAX's bound for its tp engine).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from resnet_accel_tpu.cli import main as j_main
from resnet_accel_tpu.models.lm import TransformerLMInt8 as JLM
from resnet_accel_tpu.models.transformer import TransformerBlockInt8 as JTB
from resnet_accel_tpu.parallel.heads import (
    make_tp_lm_generate as j_generate,
    make_tp_transformer_forward as j_tp_forward)
from resnet_accel_tpu.runtime.paged import PagedKVBatcher as JPB
from resnet_accel_tpu_torch import cli
from resnet_accel_tpu_torch.models.lm import from_reference
from resnet_accel_tpu_torch.models.transformer import (
    TransformerBlockInt8, TransformerBlockInt8Module)
from resnet_accel_tpu_torch.parallel import jobs, launch
from resnet_accel_tpu_torch.parallel.heads import (
    make_tp_lm_generate, make_tp_transformer_forward)
from resnet_accel_tpu_torch.runtime.paged import PagedKVBatcher

torch.set_num_threads(1)

WORLD = 4
TP2 = {"dp": 2, "tp": 2}
TP4 = {"tp": 4}
BLOCK = dict(d_model=128, n_heads=4, d_ff=256, sparsity=0.7, block=8,
             seed=5)
GEN_CFG = dict(seed=3, vocab=47, d_model=64, n_heads=4, n_layers=2,
               d_ff=128, max_len=32, sparsity=0.5)
PAGED_CFG = dict(seed=0, vocab=61, d_model=64, n_heads=4, n_layers=2,
                 max_len=48, sparsity=0.5)
PROMPT = np.array([5, 9, 2, 11, 7], np.int32)
BATCH = np.array([[5, 9, 2, 11], [3, 3, 8, 1], [7, 0, 40, 2],
                  [12, 12, 12, 12]], np.int32)
SCORE = [np.random.default_rng(5).integers(0, 61, n).tolist()
         for n in (9, 4, 17)]

#: name -> (engine arguments, rounds of (prompt, n_new, seed) requests,
#: compared with the JAX tp engine too)
PAGED = {
    "greedy": (dict(slots=2, page=8, pool_pages=9),
               [[([5, 9, 2, 44], 6, 0), ([7, 7, 1], 5, 0)]], True),
    "sampled": (dict(slots=2, page=8, pool_pages=9, temperature=0.8,
                     top_k=12),
                [[([3, 1, 4], 5, 7), ([9, 9], 4, 11)]], False),
    "admission": (dict(slots=2, page=8, pool_pages=4),
                  [[([1, 2, 3, 4, 5, 6], 6, 0), ([6, 5, 4, 3, 2, 1], 6, 0)]],
                  False),
    "ondemand": (dict(slots=3, page=4, pool_pages=7, chunk=4,
                      reserve="ondemand", temperature=0.7, top_k=9),
                 [[(list(range(2, 8)), 8, 1), ([9, 4], 10, 2),
                   ([1], 9, 3)]], False),
    "prefix": (dict(slots=2, page=8, pool_pages=12, prefix_cache=True),
               [[(list(range(10, 26)) + [3], 5, 0)],
                [(list(range(10, 26)) + [7], 5, 0)]], False),
    "int8": (dict(slots=2, page=8, pool_pages=9, kv_dtype="int8"),
             [[([5, 9, 2, 44], 8, 0), ([8, 8, 8], 6, 0)]], True),
    "spec": (dict(slots=2, page=8, pool_pages=12, spec_draft=3),
             [[([5, 9, 2, 44, 5, 9, 2], 8, 0), ([7, 3, 7, 3, 7], 6, 0)]],
             False),
    "adaptive": (dict(slots=2, page=8, pool_pages=12, spec_draft=3,
                      spec_adaptive=True, spec_min_take=999.0, spec_probe=1,
                      spec_reprobe=2),
                 [[([5, 9, 2, 44, 5, 9, 2], 8, 0),
                   ([7, 3, 7, 3, 7], 6, 0)]], False),
}


@pytest.fixture(scope="module")
def models():
    jgen = JLM.from_random(**GEN_CFG)
    gen_scales = jgen.calibrate(np.random.default_rng(2).integers(0, 47, 20))
    jpaged = JLM.from_random(**PAGED_CFG)
    paged_scales = jpaged.calibrate(
        np.random.default_rng(1).integers(0, 61, 24))
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (12, 128)).astype(np.float32)
    x_seq = np.random.default_rng(0).normal(0, 1, (10, 128)).astype(
        np.float32)
    block = TransformerBlockInt8.from_random(**BLOCK)
    return {"jblock": JTB.from_random(**BLOCK), "block": block, "x": x,
            "x_seq": x_seq, "dec_scales": block.calibrate_scales(x_seq),
            "jgen": jgen, "gen": from_reference(jgen),
            "gen_scales": gen_scales, "jpaged": jpaged,
            "paged": from_reference(jpaged), "paged_scales": paged_scales}


@pytest.fixture(scope="module")
def world(models):
    m = models
    lm, sc = m["gen"], m["gen_scales"]
    job_list = [
        ("fwd_tp2", jobs.tp_forward, (TP2, m["block"], m["x"])),
        ("fwd_tp4", jobs.tp_forward, (TP4, m["block"], m["x"])),
        ("err_tp3", jobs.raises, (make_tp_transformer_forward, {"tp": 3},
                                  (m["block"],), {"device": "cpu"})),
        ("err_no_tp", jobs.raises, (make_tp_transformer_forward, {"dp": 4},
                                    (m["block"],), {"device": "cpu"})),
        ("gen_err_no_tp", jobs.raises, (make_tp_lm_generate, {"dp": 2},
                                        (lm, sc, 4), {"device": "cpu"})),
        ("gen_err_no_dp", jobs.raises, (make_tp_lm_generate, {"tp": 2},
                                        (lm, sc, 4),
                                        {"batched": True, "device": "cpu"})),
        ("gen_err_len", jobs.raises, (make_tp_lm_generate, {"tp": 2},
                                      (lm, sc, 4),
                                      {"max_len": 999, "device": "cpu"})),
        ("paged_err_no_tp", jobs.raises, (
            PagedKVBatcher, {"dp": 2}, (m["paged"], m["paged_scales"]),
            {"device": "cpu"}, "tp_mesh")),
        ("paged_err_tp3", jobs.raises, (
            PagedKVBatcher, {"tp": 3}, (m["paged"], m["paged_scales"]),
            {"device": "cpu"}, "tp_mesh")),
    ]
    for name, axes in (("tp2", TP2), ("tp4", TP4)):
        job_list += [
            (f"dec_{name}", jobs.tp_decode, (axes, m["block"],
                                             m["dec_scales"], m["x_seq"],
                                             16)),
            (f"gen_{name}", jobs.tp_generate, (axes, lm, sc, PROMPT, 8))]
    job_list.append(("gen_batched", jobs.tp_generate,
                     (TP2, lm, sc, BATCH, 6, True)))
    for name, (engine, rounds, _) in PAGED.items():
        job_list.append((f"paged_{name}", jobs.paged_tp, (
            TP2, m["paged"], m["paged_scales"], rounds, engine,
            SCORE if name == "greedy" else None)))
    return launch.run_world(jobs.run_jobs, WORLD, device="cpu",
                            args=("cpu", job_list), timeout_s=120)


def _agreed(world, key):
    got = [r[key] for r in world if r[key] is not None]
    assert got
    for other in got[1:]:
        assert _same(other, got[0]), key
    return got[0]


def _same(a, b):
    if isinstance(a, dict):             # (each rank's own host time aside)
        return a.keys() == b.keys() and all(
            _same(a[k], b[k]) for k in a if k != "seconds")
    if isinstance(a, np.ndarray):
        return a.shape == b.shape and bool(np.array_equal(a, b))
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def _jmesh(n, names=("tp",)):
    devs = jax.devices("cpu")[:n]
    shape = (n,) if len(names) == 1 else (2, n // 2)
    return Mesh(np.array(devs).reshape(shape), names)


# ------------------------------------------------------------ forward
class TestHeadParallel:
    @pytest.mark.parametrize("tp", [2, 4])
    def test_matches_jax_and_single_device(self, world, models, tp):
        x = models["x"]
        got = _agreed(world, f"fwd_tp{tp}")
        want = np.asarray(j_tp_forward(_jmesh(tp), models["jblock"])(
            jnp.asarray(x)))
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
        single = TransformerBlockInt8Module(models["block"], "cpu")
        with torch.inference_mode():
            ref = single(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)

    @pytest.mark.parametrize("key,match", [
        ("err_tp3", "n_heads=4 not divisible by tp=3"),
        ("err_no_tp", "mesh must have a 'tp' axis")])
    def test_errors_match_jax(self, world, models, key, match):
        assert _agreed(world, key) == match
        jmesh = (_jmesh(3) if key == "err_tp3"
                 else Mesh(np.array(jax.devices("cpu")[:2]), ("dp",)))
        with pytest.raises(ValueError) as e:
            j_tp_forward(jmesh, models["jblock"])
        assert str(e.value) == match


# ------------------------------------------------------------- decode
class TestHeadParallelDecode:
    @pytest.mark.parametrize("tp", [2, 4])
    def test_matches_single_rank_and_jax(self, world, models, tp):
        got = _agreed(world, f"dec_tp{tp}")
        scales = models["dec_scales"]
        mod = TransformerBlockInt8Module(models["block"], "cpu")
        cache = mod.init_cache(16)
        jblock, jcache = models["jblock"], models["jblock"].init_cache(16)
        for t in range(10):
            xt = models["x_seq"][t:t + 1]
            with torch.inference_mode():
                y, cache = mod.decode_step(cache, torch.from_numpy(xt),
                                           scales)
            jy, jcache = jblock.decode_step(jcache, jnp.asarray(xt), scales)
            np.testing.assert_allclose(got["y"][t], y.numpy(), rtol=0,
                                       atol=1e-6)
            np.testing.assert_allclose(got["k"][t], cache["k"].numpy(),
                                       rtol=0, atol=1e-6)
            np.testing.assert_allclose(got["k"][t], np.asarray(jcache["k"]),
                                       rtol=0, atol=2e-5)
            np.testing.assert_allclose(got["y"][t], np.asarray(jy), rtol=0,
                                       atol=1e-2)
        assert got["len"] == 10

    @pytest.mark.parametrize("tp", [2, 4])
    def test_kv_cache_is_sharded(self, world, tp):
        assert _agreed(world, f"dec_tp{tp}")["k_local"] == (16, 128 // tp)


# ----------------------------------------------------------- generate
class TestFullLMTensorParallel:
    @pytest.mark.parametrize("tp", [2, 4])
    def test_tokens_match_jax_and_single_rank(self, world, models, tp):
        got = _agreed(world, f"gen_tp{tp}")
        jgen = j_generate(_jmesh(tp), models["jgen"], models["gen_scales"],
                          n_new=8)
        np.testing.assert_array_equal(got, np.asarray(jgen(PROMPT)))
        np.testing.assert_array_equal(got, models["gen"].generate(
            PROMPT, 8, models["gen_scales"], parallel_prefill=False,
            device="cpu"))

    def test_dp_tp_batched_serving(self, world, models):
        got = _agreed(world, "gen_batched")
        assert got.shape == (4, 6)
        jgen = j_generate(_jmesh(4, ("dp", "tp")), models["jgen"],
                          models["gen_scales"], n_new=6, batched=True)
        np.testing.assert_array_equal(got, np.asarray(jgen(BATCH)))
        want = models["gen"].generate(BATCH, 6, models["gen_scales"],
                                      parallel_prefill=False, batched=True,
                                      device="cpu")
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("key,match", [
        ("gen_err_no_tp", "mesh must have a 'tp' axis"),
        ("gen_err_no_dp", "batched=True needs a 'dp' axis"),
        ("gen_err_len", "max_len 999 exceeds the position table (32)")])
    def test_validation(self, world, key, match):
        assert _agreed(world, key) == match


# -------------------------------------------------------- paged engine
def _single(models, engine, rounds, score=None):
    eng = PagedKVBatcher(models["paged"], models["paged_scales"],
                         device="cpu", **engine)
    streams = []
    for reqs in rounds:
        rids = [eng.submit(p, n, seed=s) for p, n, s in reqs]
        res = eng.run()
        streams.append([res[r] for r in rids])
    return eng, streams, (eng.score(score) if score else None)


class TestPagedTP:
    @pytest.mark.parametrize("mode", sorted(PAGED))
    def test_streams_equal_single_rank(self, world, models, mode):
        engine, rounds, _ = PAGED[mode]
        got = _agreed(world, f"paged_{mode}")
        eng, streams, _ = _single(models, engine, rounds)
        assert got["streams"] == streams
        for k, v in got["counters"].items():
            assert v == getattr(eng, k), k
        assert got["free"] == eng.free_pages()
        # each rank holds its two heads' slice of every page
        assert got["slice"][-1] == 64 // 2
        assert got["pool_bytes"] == eng.kv_pool_bytes()

    @pytest.mark.parametrize("mode", [m for m in sorted(PAGED)
                                      if PAGED[m][2]])
    def test_greedy_streams_equal_jax_tp_engine(self, world, models, mode):
        engine, rounds, _ = PAGED[mode]
        got = _agreed(world, f"paged_{mode}")
        jeng = JPB(models["jpaged"], models["paged_scales"],
                   tp_mesh=_jmesh(2), **engine)
        for reqs, stream in zip(rounds, got["streams"]):
            rids = [jeng.submit(p, n, seed=s) for p, n, s in reqs]
            res = jeng.run()
            assert [res[r] for r in rids] == stream
        assert got["counters"]["micro_steps"] == jeng.micro_steps

    @pytest.mark.parametrize("mode,what", [
        ("ondemand", "preemptions"), ("prefix", "cache_tokens_skipped"),
        ("adaptive", "spec_switches")])
    def test_scenario_exercised(self, world, mode, what):
        c = _agreed(world, f"paged_{mode}")["counters"]
        assert c[what] > (16 - 1 if what == "cache_tokens_skipped" else
                          1 if what == "spec_switches" else 0)

    def test_speculation_equals_chunked(self, world):
        spec = _agreed(world, "paged_spec")["streams"]
        adaptive = _agreed(world, "paged_adaptive")["streams"]
        assert spec == adaptive

    def test_score_matches_single_rank(self, world, models):
        got = _agreed(world, "paged_greedy")["score"]
        _, _, want = _single(models, *PAGED["greedy"][:2], score=SCORE)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("key,match", [
        ("paged_err_no_tp", "mesh must have a 'tp' axis"),
        ("paged_err_tp3", "n_heads=4 not divisible by tp=3")])
    def test_rejects_bad_meshes(self, world, key, match):
        assert _agreed(world, key) == match


# ---------------------------------------------------------- serve --tp
SERVE = ["serve", "--n-new", "4", "--layers", "1", "--d-model", "64",
         "--heads", "2", "--max-len", "32", "--prompts", "1,2,3;4,5;6,7,8",
         "--pool-pages", "16", "--tp", "2", "--kv-dtype", "int8"]


def test_serve_tp_matches_jax_cli(capsys):
    assert cli.main([*SERVE, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert j_main([*SERVE, "--backend", "cpu"]) == 0
    jout = capsys.readouterr().out
    reqs = [ln for ln in out.splitlines() if ln.startswith("req ")]
    assert len(reqs) == 3 and reqs == [
        ln for ln in jout.splitlines() if ln.startswith("req ")]
    last = out.splitlines()[-1].split("; ")
    assert last[1:] == jout.splitlines()[-1].split("; ")[1:]
    assert last[-1] == "tp=2 (KV sliced by head)"
    assert last[0].endswith("on cpu, 2 ranks over gloo")


def test_serve_tp_refuses_too_few_devices(capsys):
    with pytest.raises(SystemExit, match=r"--tp 4096 needs 4096 devices, "
                                         r"have \d+"):
        cli.main([*SERVE[:-4], "--tp", "4096", "--device", "cpu"])
    with pytest.raises(SystemExit, match=r"--tp 4096 needs 4096 devices, "
                                         r"have \d+"):
        j_main([*SERVE[:-4], "--tp", "4096", "--backend", "cpu"])
