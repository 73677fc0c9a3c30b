"""PyTorch port: the spawned worlds, the mesh, the collectives, the sharded
programs and the dry run, against the JAX package, on the CPU.

The port's side runs in ONE world of four gloo ranks spawned by
``run_world`` (a module fixture running every job in order); the JAX side
runs in this process on the conftest's virtual CPU devices.  Every rank
returns its result and the tests assert that the ranks agree.

Tolerances, each with its reason:
- The mesh, the collectives (int32 sums stay int32 and wrap as int32
  does), the data-parallel logits (ResNet-18 and the MNIST CNN, served
  through the kernels' plain versions, on the CPU) and the dp BSR GEMM:
  exact.  The logits equal the JAX package's golden, which its single-
  device forward equals bit for bit (tests/test_torch_resnet18.py); its
  own dp program may flip a rounding tie across compilations
  (tests/test_parallel.py), so against it the JAX test's own criterion
  holds.
- The dp x tp Adam step: the loss history within rtol 2e-5 of the JAX
  package's ``make_sharded_train_step`` (float32 sums in another order),
  the parameters after it within JAX's bound (rtol 2e-4, atol 5e-5).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from resnet_accel_tpu import golden as jgolden
from resnet_accel_tpu.models import mnist_cnn as JM
from resnet_accel_tpu.models import resnet18 as JR
from resnet_accel_tpu.parallel import (make_mesh as j_make_mesh,
                                       make_sharded_train_step as j_train)
from resnet_accel_tpu.sparse import build_bsr_int8_direct
from resnet_accel_tpu.train import init_mnist_params
from resnet_accel_tpu_torch.models import mnist_cnn as PM
from resnet_accel_tpu_torch.models import resnet18 as PR
from resnet_accel_tpu_torch.parallel import jobs, launch
from resnet_accel_tpu_torch.parallel.dryrun import _dryrun_body
from resnet_accel_tpu_torch.parallel.mesh import make_mesh
from resnet_accel_tpu_torch.sparse.bsr import BSRMatrix

torch.set_num_threads(1)

WORLD = 4
MNIST_SHAPES = {"conv1": (32, 1, 3, 3), "conv2": (64, 32, 3, 3),
                "fc1": (128, 9216), "fc2": (10, 128)}


def _resnet():
    params = JR.init_resnet18_fp32(seed=0, num_classes=10, small_input=True)
    rng = np.random.default_rng(1)
    calib = rng.normal(0, 1, (2, 3, 32, 32)).astype(np.float32)
    ref = JR.quantize_resnet18(params, calib, 10, small_input=True)
    x = rng.normal(0, 1, (8, 3, 32, 32)).astype(np.float32)
    return ref, x


def _mnist():
    rng = np.random.default_rng(3)
    w = {k: rng.integers(-127, 128, s).astype(np.int8)
         for k, s in MNIST_SHAPES.items()}
    w["fc1"][:, 128 * 20:128 * 60] = 0          # zero blocks for fc1's BSR
    scales = {k: rng.uniform(0.002, 0.01, s[0]).astype(np.float32)
              for k, s in MNIST_SHAPES.items()}
    biases = {k: rng.normal(0, 0.05, s[0]).astype(np.float32)
              for k, s in MNIST_SHAPES.items()}
    ref = JM.MNISTCNNInt8.from_arrays(w, scales, biases,
                                      (0.021, 0.0113, 0.0049, 0.0021))
    ref = ref.with_fc1_bsr(128)
    x = rng.normal(0, 1, (8, 1, 28, 28)).astype(np.float32)
    return ref, x


def _gemm(seed, N, K, M, zero=False):
    rng = np.random.default_rng(seed)
    W = rng.integers(-128, 128, (N, K)).astype(np.int8)
    if zero:
        W[0:128, 128:256] = 0
    A = rng.integers(-128, 128, (M, K)).astype(np.int8)
    b = build_bsr_int8_direct(W, 128)
    bsr = BSRMatrix(data=np.asarray(b.data, np.int8),
                    row_ptr=np.asarray(b.row_ptr, np.int32),
                    col_idx=np.asarray(b.col_idx, np.int32),
                    shape=tuple(b.shape), block_h=128, block_w=128)
    return W, A, bsr


def _train_batch():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (8, 1, 28, 28)).astype(np.float32)
    y = rng.integers(0, 10, 8).astype(np.int32)
    return x, y


GEMMS = {"zero_block": (0, 256, 384, 64, True),
         "dense": (1, 128, 256, 32, False)}
TRAIN_MESHES = {"dp2_tp2": (2, 2), "dp4_tp1": (4, 1), "dp1_tp4": (1, 4)}
TRAIN_STEPS = 2


@pytest.fixture(scope="module")
def inputs():
    res, rx = _resnet()
    mn, mx = _mnist()
    return {"resnet": (res, rx), "mnist": (mn, mx),
            "gemm": {k: _gemm(*v) for k, v in GEMMS.items()},
            "train": _train_batch()}


@pytest.fixture(scope="module")
def world(inputs):
    """Every port program of this file in one world of four gloo ranks."""
    res, rx = inputs["resnet"]
    mn, mx = inputs["mnist"]
    tx, ty = inputs["train"]
    p0 = init_mnist_params(seed=0)
    job_list = [
        ("world", jobs.world_info, ()),
        ("mesh_default", jobs.mesh_info, ()),
        ("mesh_tp2", jobs.mesh_info, (None, 2)),
        ("mesh_1x2", jobs.mesh_info, (1, 2)),
        ("mesh_too_big", jobs.raises, (make_mesh, None, (8, 2))),
        ("mesh_indivisible", jobs.raises, (make_mesh, None, (None, 3))),
        ("coll", jobs.collectives_check, ()),
        ("dp_resnet", jobs.dp_forward, (PR.from_reference(res), rx)),
        ("dp_resnet_dp2", jobs.dp_forward, (PR.from_reference(res), rx, 2)),
        ("dp_mnist", jobs.dp_forward, (PM.from_reference(mn), mx)),
    ]
    job_list += [(f"gemm_{k}", jobs.dp_bsr, (v[2], v[1]))
                 for k, v in inputs["gemm"].items()]
    job_list += [(f"train_{k}", jobs.sharded_train,
                  (dp, tp, p0, tx, ty, TRAIN_STEPS))
                 for k, (dp, tp) in TRAIN_MESHES.items()]
    job_list += [("train_one", jobs.sharded_train, (2, 2, p0, tx, ty, 1)),
                 ("dryrun", _dryrun_body, ())]
    return launch.run_world(jobs.run_jobs, WORLD, device="cpu",
                            args=("cpu", job_list), timeout_s=120)


def _agreed(world, key):
    """The ranks' results of ``key`` (None from ranks outside the mesh
    dropped), asserted equal; returns rank 0's."""
    got = [r[key] for r in world if r[key] is not None]
    for other in got[1:]:
        _assert_same(other, got[0])
    return got[0]


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        assert a == b


# ------------------------------------------------------------- launch
class TestLaunch:
    def test_world_runs_gloo_on_cpu(self, world):
        infos = [r["world"] for r in world]
        assert [i["rank"] for i in infos] == list(range(WORLD))
        assert {i["backend"] for i in infos} == {"gloo"}
        assert {i["device"] for i in infos} == {"cpu"}

    def test_nccl_refuses_the_cpu(self):
        with pytest.raises(ValueError, match="nccl runs on CUDA only"):
            launch.run_world(jobs.world_info, 2, device="cpu",
                             backend="nccl")
        with pytest.raises(ValueError, match="backend must be one of"):
            launch.run_world(jobs.world_info, 2, device="cpu",
                             backend="mpi")

    def test_available_devices(self):
        assert launch.default_backend("cpu") == "gloo"
        assert launch.available_devices("cpu") == (os.cpu_count() or 1)

    def test_failing_rank_fails_the_world(self):
        # make_mesh(dp=8, tp=2) raises in every rank of a world of two
        with pytest.raises(RuntimeError) as e:
            launch.run_world(jobs.mesh_info, 2, device="cpu", args=("cpu",
                                                                   8, 2))
        msg = str(e.value)
        assert "exited with code 1" in msg and "rank 0:" in msg
        assert "mesh 8x2 needs 16 devices, have 2" in msg

    def test_timeout_kills_the_world(self):
        with pytest.raises(RuntimeError, match="did not finish in 0 s"):
            launch.run_world(jobs.world_info, 2, device="cpu",
                             args=("cpu",), timeout_s=0.2)


# --------------------------------------------------------------- mesh
class TestMesh:
    @pytest.mark.parametrize("key,shape", [
        ("mesh_default", {"dp": 4, "tp": 1}),
        ("mesh_tp2", {"dp": 2, "tp": 2}),
        ("mesh_1x2", {"dp": 1, "tp": 2})])
    def test_make_mesh_shapes(self, world, key, shape):
        infos = [r[key] for r in world]
        n = shape["dp"] * shape["tp"]
        assert all(i is None for i in infos[n:])       # outside the mesh
        assert all(i["shape"] == shape for i in infos[:n])
        assert [i["coord"] for i in infos[:n]] == [
            (d, t) for d in range(shape["dp"]) for t in range(shape["tp"])]
        j = j_make_mesh(dp=shape["dp"], tp=shape["tp"],
                        devices=jax.devices("cpu")[:n])
        assert dict(j.shape) == shape

    @pytest.mark.parametrize("key,jax_args", [
        ("mesh_too_big", dict(dp=8, tp=2)),
        ("mesh_indivisible", dict(tp=3))])
    def test_errors_match_jax(self, world, key, jax_args):
        msg = _agreed(world, key)
        with pytest.raises(ValueError) as e:
            j_make_mesh(devices=jax.devices("cpu")[:WORLD], **jax_args)
        assert msg == str(e.value)


# -------------------------------------------------------- collectives
class TestCollectives:
    def test_psum_int32_stays_int32(self, world):
        for r, res in enumerate(world):
            c = res["coll"]
            assert c["dtype"] == "torch.int32"
            pair = (r // 2) * 2
            want = np.array([2 ** 30 + pair + 2 ** 30 + pair + 1],
                            np.int64).astype(np.int32)  # wraps
            np.testing.assert_array_equal(c["psum_i32"], want)

    @pytest.mark.parametrize("name", ["psum", "pmax", "gather", "stack"])
    def test_reductions_and_gathers(self, world, name):
        for r, res in enumerate(world):
            pair = (r // 2) * 2
            xs = [np.arange(3, dtype=np.float32) + 10 * (pair + i)
                  for i in range(2)]
            want = {"psum": xs[0] + xs[1], "pmax": np.maximum(*xs),
                    "gather": np.concatenate(xs), "stack": np.stack(xs)}
            np.testing.assert_array_equal(res["coll"][name], want[name])

    def test_ppermute_and_its_transpose(self, world):
        for r, res in enumerate(world):
            c = res["coll"]
            t = r % 2
            other = np.arange(3, dtype=np.float32) + 10 * (r - t + 1 - t)
            np.testing.assert_array_equal(c["ring"], other)
            # (0 -> 1): index 1 receives, index 0 gets zeros
            np.testing.assert_array_equal(
                c["hop"], other if t == 1 else np.zeros(3, np.float32))
            # d/dx of sum(psum*w) + 2 sum(gather[:3]) + sum(ring*w) +
            # 3 sum(hop): psum passes w through, the gather hands index 0
            # its slice, the ring and the hop send cotangents back
            w = np.arange(1, 4, dtype=np.float32)
            want = w + w + (2 + 3 if t == 0 else 0)
            np.testing.assert_array_equal(c["grad"], want)


# ------------------------------------------------------------ sharded
@pytest.fixture(scope="module")
def resnet_golden(inputs):
    ref, x = inputs["resnet"]
    return JR.forward_golden(ref, x[:2])


class TestDataParallelServing:
    @pytest.mark.parametrize("key", ["dp_resnet", "dp_resnet_dp2"])
    def test_resnet_bit_exact_vs_golden(self, world, inputs, resnet_golden,
                                        key):
        ref, x = inputs["resnet"]
        got = _agreed(world, key)
        assert got["counts"] is None            # the plain versions ran
        assert got["rows"] == len(x) // (4 if key == "dp_resnet" else 2)
        # the golden of the first two images (the numpy golden takes
        # seconds an image), the rest against the single-rank port below
        np.testing.assert_array_equal(got["logits"][:2], resnet_golden)

    def test_resnet_vs_jax_dp_program(self, world, inputs):
        ref, x = inputs["resnet"]
        from resnet_accel_tpu.parallel import make_data_parallel_forward
        mesh = j_make_mesh(dp=4, tp=1, devices=jax.devices("cpu")[:4])
        fwd, params, put = make_data_parallel_forward(
            ref, JR.make_forward, mesh, use_pallas=False, backend="cpu")
        jout = np.asarray(fwd(params, put(x)))
        out = _agreed(world, "dp_resnet")["logits"]
        # the JAX test's criterion for its dp program against one device
        same = np.isclose(out, jout, rtol=0.05, atol=0.05) | (out == jout)
        assert float((out == jout).mean()) > 0.9 and same.mean() > 0.99

    def test_mnist_bit_exact_vs_golden(self, world, inputs):
        ref, x = inputs["mnist"]
        got = _agreed(world, "dp_mnist")
        assert ref.fc1_bsr is not None
        np.testing.assert_array_equal(got["logits"],
                                      JM.forward_golden(ref, x))

    @pytest.mark.parametrize("key", ["dp_resnet", "dp_resnet_dp2"])
    def test_logits_equal_the_single_rank_port(self, world, inputs,
                                               resnet_golden, key):
        ref, x = inputs["resnet"]
        mod = PR.ResNet18Int8Module(PR.from_reference(ref), "cpu")
        with torch.inference_mode():
            single = mod.forward_plain(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(single[:2], resnet_golden)
        np.testing.assert_array_equal(_agreed(world, key)["logits"], single)


class TestDataParallelBSR:
    @pytest.mark.parametrize("case", sorted(GEMMS))
    def test_bit_exact_vs_golden(self, world, inputs, case):
        W, A, _ = inputs["gemm"][case]
        got = _agreed(world, f"gemm_{case}")
        assert got["out"].dtype == np.int32
        np.testing.assert_array_equal(got["out"],
                                      jgolden.matmul_int8(A, W.T))


@pytest.fixture(scope="module")
def jax_losses(inputs):
    """The JAX package's dp x tp step on the same batch, TRAIN_STEPS
    times, on a 2 x 2 mesh of virtual devices."""
    x, y = inputs["train"]
    mesh = j_make_mesh(dp=2, tp=2, devices=jax.devices("cpu")[:4])
    init_fn, step_fn, shard_batch = j_train(mesh)
    params, opt = init_fn(init_mnist_params(seed=0))
    xs, ys = shard_batch(x, y)
    losses, after = [], None
    for i in range(TRAIN_STEPS):
        params, opt, loss = step_fn(params, opt, xs, ys)
        losses.append(float(loss))
        if i == 0:
            after = {k: np.asarray(v) for k, v in params.items()}
    return losses, after


class TestShardedTrain:
    @pytest.mark.parametrize("mesh", sorted(TRAIN_MESHES))
    def test_loss_history_follows_jax(self, world, jax_losses, mesh):
        got = _agreed(world, f"train_{mesh}")
        # (Adam overshoots on this random batch, as in the JAX test of the
        # combined mesh: the history is held, not its direction)
        np.testing.assert_allclose(got["losses"], jax_losses[0], rtol=2e-5)

    def test_fc1_actually_sharded(self, world):
        for r in world:
            assert r["train_dp2_tp2"]["fc1_rows"] == (64, 9216)
            assert r["train_dp1_tp4"]["fc1_rows"] == (32, 9216)

    def test_one_step_params_match_jax(self, world, jax_losses):
        got = _agreed(world, "train_one")
        for k, v in jax_losses[1].items():
            np.testing.assert_allclose(got["params"][k], v, rtol=2e-4,
                                       atol=5e-5, err_msg=k)

    def test_matches_single_device_math(self, world, inputs):
        """The first loss is the unsharded forward's mean cross-entropy."""
        from resnet_accel_tpu.train.mnist import mnist_forward_fp32
        import optax
        x, y = inputs["train"]
        p = {k: jnp.asarray(v) for k, v in init_mnist_params(0).items()}
        want = float(optax.softmax_cross_entropy_with_integer_labels(
            mnist_forward_fp32(p, jnp.asarray(x)), jnp.asarray(y)).mean())
        got = _agreed(world, "train_dp2_tp2")["losses"][0]
        np.testing.assert_allclose(got, want, rtol=2e-5)


# ------------------------------------------------------------- dryrun
class TestDryrun:
    def test_line_and_loss(self, world):
        line = _agreed(world, "dryrun")
        assert line.startswith(
            "dryrun_multichip OK: dp=2 tp=2 (+tp-attention=2 +tp-decode=2 "
            "+tp-lm-generate=2(token-exact) +paged-tp=2(token-exact)) "
            "pp=2/4 sp=4 ep=2 lm-serve=dp2xtp2(token-exact) all exercised;")
        assert line.endswith("serve out (4, 10)")

    def test_loss_is_the_jax_step_loss(self, world):
        """The dry run's train loss: JAX's dp x tp step on the dry run's
        batch (2 * dp seeded images), printed to 4 places."""
        rng = np.random.default_rng(0)
        x = rng.normal(0, 1, (4, 1, 28, 28)).astype(np.float32)
        y = rng.integers(0, 10, 4).astype(np.int32)
        mesh = j_make_mesh(dp=2, tp=2, devices=jax.devices("cpu")[:4])
        init_fn, step_fn, shard_batch = j_train(mesh)
        params, opt = init_fn(init_mnist_params(seed=0))
        _, _, loss = step_fn(params, opt, *shard_batch(x, y))
        assert f"train loss {float(loss):.4f}," in _agreed(world, "dryrun")

    def test_dryrun_multichip_entry(self, capsys):
        """The entry point spawns its own world (two ranks here) and prints
        the line that rank 0 returns."""
        from resnet_accel_tpu_torch.parallel.dryrun import dryrun_multichip
        line = dryrun_multichip(2, device="cpu")
        assert capsys.readouterr().out.strip() == line
        assert line.startswith(
            "dryrun_multichip OK: dp=1 tp=2 (+tp-attention=2 +tp-decode=2 "
            "+tp-lm-generate=2(token-exact) +paged-tp=2(token-exact)) "
            "pp=2/2 sp=2 ep=2 all exercised; train loss ")
        assert line.endswith("serve out (2, 10)")


def test_exports_match_jax():
    """Every name of the JAX package's ``parallel.__all__`` has its
    counterpart, loaded at first use."""
    import resnet_accel_tpu.parallel as jp
    import resnet_accel_tpu_torch.parallel as pp
    assert set(jp.__all__) <= set(pp.__all__)
    for name in pp.__all__:
        assert callable(getattr(pp, name)), name
