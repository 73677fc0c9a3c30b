"""PyTorch port: sequence parallelism, the MoE block and expert
parallelism, pipeline parallelism and the combined dp x pp x tp mesh,
against the JAX package, on the CPU.

The port's side runs in ONE world of four gloo ranks (a module fixture);
ep 2 runs on a (dp 2, ep 2) mesh, pp 3 on the first three ranks.  The JAX
side runs in this process on the conftest's virtual CPU devices, at the
JAX tests' sizes (tests/test_moe_sp.py, tests/test_pipeline.py,
tests/test_combined_mesh.py).

Tolerances, each with its reason:
- sp: within 1e-4 of the single-rank block and of the numpy golden, JAX's
  own sp bound (the quantization scale is the global absmax; float32 LN
  and softmax sums reassociate); within 2e-3 of the JAX package's sp
  program, which lands one int8 rounding tie off the golden on this input
  (the bound tests/test_lm.py allows the JAX forward against the golden).
- MoE and ep: the seeded weights and the routing equal the JAX package's;
  the ep output equals the port's single-rank block bit for bit (each
  token's sum has one nonzero term), and is within JAX's own ep bound
  (rtol 1e-5, atol 1e-6) of the JAX package's ep program, and within
  2e-3 of its golden.
- pipeline: the MNIST stages within 1e-5 of the JAX pipeline and of
  ``mnist_forward_fp32`` (JAX's bound); the transformer stages within 2e-5
  of the JAX blocks run per microbatch (the pipeline's semantics); the
  gradient through the pipe within 1e-5 of the unsharded forward's.
- combined: the forward within 1e-5 of the JAX combined program and of the
  unsharded forward; one Adam step's loss within rtol 1e-5 of the
  unsharded step's, its parameters by tests/test_torch_train_mnist.py's
  rule (at least 0.999 of each parameter's elements within atol 1e-5 +
  rtol 1e-4, none beyond 8 lr: Adam divides by the root of the second
  moment, so an element whose gradient is near the rounding noise moves by
  about lr either way -- here one fc1 element of 1.2 M, by 1.2e-4); a
  four-step loss history within rtol 1e-4 of JAX's.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from resnet_accel_tpu.models.moe import MoEBlockInt8 as JMoE
from resnet_accel_tpu.models.transformer import TransformerBlockInt8 as JTB
from resnet_accel_tpu.parallel.combined import (
    make_combined_forward as j_combined, make_combined_mesh as j_cmesh)
from resnet_accel_tpu.parallel.experts import make_ep_moe_forward as j_ep
from resnet_accel_tpu.parallel.pipeline import (
    make_pipeline_forward as j_pipe, mnist_pipeline_stages as j_stages)
from resnet_accel_tpu.parallel.sequence import \
    make_sp_transformer_forward as j_sp
from resnet_accel_tpu.train import init_mnist_params
from resnet_accel_tpu.train.mnist import mnist_forward_fp32 as j_mnist
from resnet_accel_tpu_torch.models import moe as PMoE
from resnet_accel_tpu_torch.models.transformer import (
    TransformerBlockInt8, TransformerBlockInt8Module)
from resnet_accel_tpu_torch.parallel import jobs, launch
from resnet_accel_tpu_torch.parallel.combined import make_combined_mesh
from resnet_accel_tpu_torch.parallel.experts import make_ep_moe_forward
from resnet_accel_tpu_torch.parallel.pipeline import make_pipeline_forward
from resnet_accel_tpu_torch.parallel.sequence import \
    make_sp_transformer_forward
from resnet_accel_tpu_torch.train.mnist import mnist_forward_fp32

torch.set_num_threads(1)

WORLD = 4
SP_BLOCK = dict(d_model=128, n_heads=4, d_ff=256, sparsity=0.8, seed=0)
C_STEPS = 4
C_MESHES = {"dp1_pp2_tp2": {"dp": 1, "pp": 2, "tp": 2},
            "dp2_pp2_tp1": {"dp": 2, "pp": 2, "tp": 1}}


def _rng_normal(seed, shape):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _batch(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (n, 1, 28, 28)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


@pytest.fixture(scope="module")
def data():
    t4 = [TransformerBlockInt8.from_random(seed=i, d_model=64, n_heads=4,
                                           d_ff=128) for i in range(4)]
    t5 = [TransformerBlockInt8.from_random(seed=10 + i, d_model=64,
                                           n_heads=4, d_ff=128)
          for i in range(5)]
    return {
        "sp_block": TransformerBlockInt8.from_random(**SP_BLOCK),
        "sp_x": _rng_normal(1, (16, 128)),
        "moe": PMoE.MoEBlockInt8.from_random(n_experts=4, seed=0),
        "ep_x": _rng_normal(2, (32, 128)),
        "moe3": PMoE.MoEBlockInt8.from_random(n_experts=4, seed=3),
        "ep_x3": _rng_normal(4, (16, 128)),
        "mnist": init_mnist_params(seed=0),
        "pp_x": _rng_normal(1, (16, 1, 28, 28)),
        "pp_x1": _rng_normal(3, (8, 1, 28, 28)),
        "t4": t4, "t5": t5, "t_x": _rng_normal(7, (8, 64)),
        "t_x5": _rng_normal(8, (4, 64)),
        "c_params": init_mnist_params(seed=3),
        "c_x": _batch(8)[0], "c_train": _batch(8, seed=1)}


@pytest.fixture(scope="module")
def world(data):
    d = data
    mn = d["mnist"]
    job_list = [
        ("sp", jobs.sp_forward, ({"sp": 4}, d["sp_block"], d["sp_x"])),
        ("sp_err", jobs.raises, (make_sp_transformer_forward, {"dp": 2},
                                 (d["sp_block"],), {"device": "cpu"})),
        ("ep2", jobs.ep_forward, ({"dp": 2, "ep": 2}, d["moe"], d["ep_x"])),
        ("ep4", jobs.ep_forward, ({"ep": 4}, d["moe3"], d["ep_x3"])),
        ("ep_err3", jobs.raises, (make_ep_moe_forward, {"ep": 3},
                                  (d["moe"],), {"device": "cpu"})),
        ("ep_err_axis", jobs.raises, (make_ep_moe_forward, {"dp": 2},
                                      (d["moe"],), {"device": "cpu"})),
        ("pp_err_axis", jobs.raises, (make_pipeline_forward, {"dp": 2},
                                      ([], 4))),
        # (rank functions take rank and world first; raises passes these)
        ("pp_err_stages", jobs.raises, (jobs.pipeline_forward, None, (
            0, WORLD, "cpu", {"pp": 2}, "mnist", mn, 3, 4, d["pp_x"]))),
        ("pp1", jobs.pipeline_forward, ({"pp": 2}, "mnist", mn, 2, 8,
                                        d["pp_x1"])),
        ("pp_grad", jobs.pipeline_forward, ({"pp": 2}, "mnist", mn, 2, 4,
                                            d["pp_x"][:4], True)),
        ("tp_uneven", jobs.pipeline_forward, ({"pp": 2}, "transformer",
                                              d["t5"], 2, 4, d["t_x5"])),
        ("c_err_mesh", jobs.raises, (make_combined_mesh, None, (2, 2, 2),
                                     {"device": "cpu"})),
    ]
    job_list += [(f"pp_mnist{k}", jobs.pipeline_forward,
                  ({"pp": k}, "mnist", mn, k, 4, d["pp_x"]))
                 for k in (2, 3, 4)]
    job_list += [(f"pp_t{k}", jobs.pipeline_forward,
                  ({"pp": k}, "transformer", d["t4"], k, 2, d["t_x"]))
                 for k in (2, 4)]
    for name, axes in C_MESHES.items():
        x, y = d["c_train"]
        job_list += [
            (f"c_fwd_{name}", jobs.combined_forward,
             (axes, d["c_params"], d["c_x"])),
            (f"c_train_{name}", jobs.combined_train,
             (axes, d["c_params"], x, y, C_STEPS)),
            (f"c_one_{name}", jobs.combined_train,
             (axes, d["c_params"], x, y, 1))]
    job_list.append(("c_err_mb", jobs.raises, (
        jobs.combined_forward, None,
        (0, WORLD, "cpu", C_MESHES["dp1_pp2_tp2"], d["c_params"], d["c_x"],
         3))))
    return launch.run_world(jobs.run_jobs, WORLD, device="cpu",
                            args=("cpu", job_list), timeout_s=120)


def _agreed(world, key):
    got = [r[key] for r in world if r[key] is not None]
    assert got
    for other in got[1:]:
        assert _same(other, got[0]), key
    return got[0]


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray):
        return a.shape == b.shape and bool(np.array_equal(a, b))
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def _jmesh(n, name):
    return Mesh(np.array(jax.devices("cpu")[:n]), (name,))


def _jparams(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


# ------------------------------------------------------------ sequence
class TestSequenceParallel:
    def test_matches_jax_and_single_device(self, world, data):
        got = _agreed(world, "sp")
        x = data["sp_x"]
        single = TransformerBlockInt8Module(data["sp_block"], "cpu")
        with torch.inference_mode():
            ref = single(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got, data["sp_block"].forward_golden(x),
                                   rtol=1e-4, atol=1e-4)
        # the JAX block lands one int8 rounding tie away from its own golden
        # on this input (4.5e-4 at 15 outputs; its sp program with it):
        # against JAX, the 2e-3 that tests/test_lm.py allows it there
        jblock = JTB.from_random(**SP_BLOCK)
        want = np.asarray(j_sp(_jmesh(4, "sp"), jblock)(jnp.asarray(x)))
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)

    def test_requires_sp_axis(self, world):
        assert _agreed(world, "sp_err") == "mesh must have a 'sp' axis"


# ----------------------------------------------------------------- MoE
class TestMoE:
    def test_from_random_identical_to_jax(self, data):
        jm = JMoE.from_random(n_experts=4, seed=0)
        pm = data["moe"]
        np.testing.assert_array_equal(pm.router_w, jm.router_w)
        ref = PMoE.from_reference(jm)
        for a, b, c in zip(pm.experts, jm.experts, ref.experts):
            for name in ("w1", "w2"):
                x, y, z = (getattr(e, name) for e in (a, b, c))
                for f in ("data", "row_ptr", "col_idx"):
                    np.testing.assert_array_equal(getattr(x.bsr, f),
                                                  getattr(y.bsr, f))
                    np.testing.assert_array_equal(getattr(z.bsr, f),
                                                  getattr(y.bsr, f))
                np.testing.assert_array_equal(x.scales, y.scales)
                np.testing.assert_array_equal(x.bias, y.bias)
        assert pm.sparsity_report() == jm.sparsity_report()

    def test_sparsity_report(self):
        rep = PMoE.MoEBlockInt8.from_random(n_experts=2, sparsity=0.8,
                                            seed=0).sparsity_report()
        assert len(rep) == 2 and all(0.7 < v < 0.9 for v in rep.values())

    def test_forward_and_routing_vs_jax(self, data):
        jm = JMoE.from_random(n_experts=4, seed=0)
        x = data["ep_x"]
        mod = data["moe"].module("cpu")
        with torch.inference_mode():
            got = mod(x).numpy()
            sel = mod.route(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(sel, np.asarray(jm.route(
            jnp.asarray(x))))
        np.testing.assert_allclose(got, np.asarray(jm(jnp.asarray(x))),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got, data["moe"].forward_golden(x),
                                   rtol=2e-3, atol=2e-3)
        np.testing.assert_array_equal(data["moe"].forward_golden(x),
                                      jm.forward_golden(x))

    def test_all_experts_used(self):
        moe = PMoE.MoEBlockInt8.from_random(n_experts=4, seed=5)
        x = _rng_normal(6, (128, 128))
        with torch.inference_mode():
            sel = moe.module("cpu").route(torch.from_numpy(x)).numpy()
        assert len(np.unique(sel)) >= 3


class TestExpertParallel:
    @pytest.mark.parametrize("key,moe,x", [("ep2", "moe", "ep_x"),
                                           ("ep4", "moe3", "ep_x3")])
    def test_equals_single_rank_bit_for_bit(self, world, data, key, moe, x):
        got = _agreed(world, key)
        with torch.inference_mode():
            single = data[moe].module("cpu")(data[x]).numpy()
        np.testing.assert_array_equal(got, single)

    def test_matches_jax_ep_program(self, world, data):
        got = _agreed(world, "ep2")
        jm = JMoE.from_random(n_experts=4, seed=0)
        want = np.asarray(j_ep(_jmesh(2, "ep"), jm)(jnp.asarray(
            data["ep_x"])))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    def test_matches_golden(self, world, data):
        np.testing.assert_allclose(
            _agreed(world, "ep4"), data["moe3"].forward_golden(
                data["ep_x3"]), rtol=2e-3, atol=2e-3)

    @pytest.mark.parametrize("key,match", [
        ("ep_err3", "4 experts not divisible by ep=3"),
        ("ep_err_axis", "mesh must have an 'ep' axis")])
    def test_errors_match_jax(self, world, data, key, match):
        assert _agreed(world, key) == match
        jm = JMoE.from_random(n_experts=4, seed=0)
        mesh = _jmesh(3, "ep") if key == "ep_err3" else _jmesh(2, "dp")
        with pytest.raises(ValueError) as e:
            j_ep(mesh, jm)
        assert str(e.value) == match


# ------------------------------------------------------------ pipeline
class TestPipelineMNIST:
    @pytest.mark.parametrize("depth", [2, 3, 4])
    def test_matches_single_device_forward(self, world, data, depth):
        got = _agreed(world, f"pp_mnist{depth}")
        x = data["pp_x"]
        want = np.asarray(j_mnist(_jparams(data["mnist"]), jnp.asarray(x)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        if depth == 2:
            jfwd = j_pipe(_jmesh(2, "pp"), j_stages(data["mnist"], 2),
                          microbatch=4)
            np.testing.assert_allclose(got, np.asarray(jfwd(jnp.asarray(x))),
                                       rtol=1e-5, atol=1e-5)

    def test_single_microbatch(self, world, data):
        x = data["pp_x1"]
        np.testing.assert_allclose(
            _agreed(world, "pp1"),
            np.asarray(j_mnist(_jparams(data["mnist"]), jnp.asarray(x))),
            rtol=1e-5, atol=1e-5)

    def test_differentiable_through_pipe(self, world, data):
        got = _agreed(world, "pp_grad")
        x = torch.from_numpy(data["pp_x"][:4]).requires_grad_(True)
        p = {k: torch.from_numpy(v) for k, v in data["mnist"].items()}
        out = mnist_forward_fp32(p, x)
        out.sum().backward()
        np.testing.assert_allclose(got["out"], out.detach().numpy(),
                                   rtol=1e-5, atol=1e-5)
        assert np.abs(got["grad"]).sum() > 0
        np.testing.assert_allclose(got["grad"], x.grad.numpy(), rtol=1e-5,
                                   atol=1e-5)

    @pytest.mark.parametrize("key,match", [
        ("pp_err_axis", "mesh must have a 'pp' axis"),
        ("pp_err_stages", "3 stages for a 2-deep 'pp' axis")])
    def test_errors(self, world, key, match):
        assert _agreed(world, key).startswith(match)


@pytest.fixture(scope="module")
def jax_stack(data):
    """The four JAX blocks run per microbatch of 2 (their dynamic scales
    per microbatch: the pipeline's semantics)."""
    jblocks = [JTB.from_random(seed=i, d_model=64, n_heads=4, d_ff=128)
               for i in range(4)]
    x, mb = data["t_x"], 2
    exps = []
    for i in range(0, len(x), mb):
        e = jnp.asarray(x[i:i + mb])
        for blk in jblocks:
            e = blk(e)
        exps.append(np.asarray(e))
    return np.concatenate(exps)


class TestPipelineTransformer:
    @pytest.mark.parametrize("depth", [2, 4])
    def test_matches_unsharded_stack(self, world, jax_stack, depth):
        np.testing.assert_allclose(_agreed(world, f"pp_t{depth}"), jax_stack,
                                   rtol=2e-5, atol=2e-5)

    def test_uneven_grouping(self, world, data):
        got = _agreed(world, "tp_uneven")        # 5 blocks -> 3 + 2
        e = jnp.asarray(data["t_x5"])
        for i in range(5):
            e = JTB.from_random(seed=10 + i, d_model=64, n_heads=4,
                                d_ff=128)(e)
        np.testing.assert_allclose(got, np.asarray(e), rtol=2e-5, atol=2e-5)


# ------------------------------------------------------------ combined
def _jax_adam_history(params, x, y, steps):
    opt = optax.adam(1e-3)
    p = _jparams(params)
    st = opt.init(p)

    def loss_fn(q):
        return optax.softmax_cross_entropy_with_integer_labels(
            j_mnist(q, jnp.asarray(x)), jnp.asarray(y)).mean()

    step = jax.jit(lambda q, s: (jax.value_and_grad(loss_fn)(q), s))
    losses, first = [], None
    for i in range(steps):
        (loss, g), _ = step(p, st)
        upd, st = opt.update(g, st)
        p = optax.apply_updates(p, upd)
        losses.append(float(loss))
        if i == 0:
            first = {k: np.asarray(v) for k, v in p.items()}
    return losses, first


class TestCombined:
    @pytest.mark.parametrize("mesh", sorted(C_MESHES))
    def test_forward_matches_jax_and_unsharded(self, world, data, mesh):
        got = _agreed(world, f"c_fwd_{mesh}")
        p, x = _jparams(data["c_params"]), jnp.asarray(data["c_x"])
        assert got.shape == (8, 10)
        np.testing.assert_allclose(got, np.asarray(j_mnist(p, x)),
                                   rtol=1e-5, atol=1e-5)
        jfwd = j_combined(j_cmesh(jax.devices("cpu"), 2, 2, 2),
                          microbatch=2)
        np.testing.assert_allclose(got, np.asarray(jfwd(p, x)), rtol=1e-5,
                                   atol=1e-5)

    def test_batch_not_multiple_raises(self, world):
        assert _agreed(world, "c_err_mb") == (
            "per-dp batch 8 not divisible by microbatch 3")

    @pytest.mark.parametrize("mesh", sorted(C_MESHES))
    def test_train_step_matches_unsharded(self, world, data, mesh):
        got = _agreed(world, f"c_one_{mesh}")
        x, y = data["c_train"]
        losses, first = _jax_adam_history(data["c_params"], x, y, 1)
        np.testing.assert_allclose(got["losses"][0], losses[0], rtol=1e-5)
        assert set(got["params"]) == set(first)
        for k, v in first.items():
            d = np.abs(got["params"][k] - v)
            close = d <= 1e-5 + 1e-4 * np.abs(v)
            assert close.mean() >= 0.999, (k, float(d.max()))
            assert d.max() <= 8 * 1e-3, (k, float(d.max()))

    @pytest.mark.parametrize("mesh", sorted(C_MESHES))
    def test_loss_history_follows_jax(self, world, data, mesh):
        got = _agreed(world, f"c_train_{mesh}")
        x, y = data["c_train"]
        losses, _ = _jax_adam_history(data["c_params"], x, y, C_STEPS)
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-4)

    def test_mesh_validation(self, world):
        assert _agreed(world, "c_err_mesh") == \
            "mesh 2x2x2 needs 8 devices, have 4"
        with pytest.raises(ValueError, match="needs 8 devices, have 4"):
            j_cmesh(jax.devices("cpu")[:4], dp=2, pp=2, tp=2)
