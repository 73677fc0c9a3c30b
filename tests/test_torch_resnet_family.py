"""PyTorch port: the ResNet family (18/34/50/101/152) against the JAX
package.

Mirrors tests/test_resnet_family.py.  Init draws identical weights at
every depth; calibration (with each of its options) agrees to float
tolerance (rtol 1e-5: the calibration forward sums floats in another
order); with the JAX package's quantized model carried across by
``from_reference``, the port's forward on the CPU is bit-identical
(tolerance 0) to the numpy golden ``forward_golden`` and to the JAX
``make_forward(expand_fused=True)`` -- its K7 kernel in Pallas interpret
mode -- on a narrow bottleneck plan, and to the golden on a narrow
basic-block plan.  Where the two JAX answers ever differ, the golden
decides.  The real plans are checked for structure only.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from resnet_accel_tpu.models import resnet as JR
from resnet_accel_tpu.models import resnet18 as J
from resnet_accel_tpu_torch import cli
from resnet_accel_tpu_torch.models import resnet as PR
from resnet_accel_tpu_torch.models import resnet18 as P

torch.set_num_threads(2)

# Narrow plans at CIFAR geometry (3x3 stem, no pool), 16 x 16 inputs:
# bottlenecks whose stage-1 downsample is 1x1 stride 1 (64 -> 128 channels,
# as ResNet-50's 64 -> 256) and a stride-2 stage with an identity block;
# and a depth-34-style basic-block plan.
BOTTLENECK = [(32, 1, 1), (32, 2, 2)]
BASIC = [(16, 3, 1), (32, 2, 2)]
HW, CLASSES = 16, 10


def _x(n, seed, hw=HW):
    return np.random.default_rng(seed).normal(
        0, 1, (n, 3, hw, hw)).astype(np.float32)


def _quantize(pkg, params, stages, bottleneck, **kw):
    return pkg.quantize_resnet18(params, _x(4, 1), CLASSES,
                                 small_input=True, stages=stages,
                                 bottleneck=bottleneck, **kw)


@pytest.fixture(scope="module")
def narrow():
    params = J.init_resnet18_fp32(seed=0, num_classes=CLASSES,
                                  small_input=True, stages=BOTTLENECK,
                                  bottleneck=True)
    ref = _quantize(J, params, BOTTLENECK, True)
    return dict(params=params, ref=ref, port=P.from_reference(ref))


def _assert_same_quantization(ref, got):
    """Same int8 weights, geometry and block kinds; float scales to rtol
    1e-5."""
    np.testing.assert_allclose(got.s_input, ref.s_input, rtol=1e-5)
    assert [n for n, _ in got.named_convs()] == \
        [n for n, _ in ref.named_convs()]
    for (name, a), (_, b) in zip(ref.named_convs(), got.named_convs()):
        np.testing.assert_array_equal(a.w2d, b.w2d, err_msg=name)
        np.testing.assert_allclose(b.factors, a.factors, rtol=1e-5,
                                   err_msg=name)
        assert (a.in_channels, a.kernel, a.stride, a.padding, a.relu) == \
            (b.in_channels, b.kernel, b.stride, b.padding, b.relu), name
    for a, b in zip(ref.blocks, got.blocks):
        assert type(a).__name__ == type(b).__name__
        np.testing.assert_allclose(
            [b.s_in, b.s_main, b.s_res, b.s_out],
            [a.s_in, a.s_main, a.s_res, a.s_out], rtol=1e-5)
    np.testing.assert_array_equal(got.fc_w, ref.fc_w)
    np.testing.assert_allclose(got.fc_deq, ref.fc_deq, rtol=1e-5)


class TestPlans:
    @pytest.mark.parametrize("depth", [18, 34, 50, 101, 152])
    def test_init_identical_to_jax(self, depth):
        a = JR.init_resnet_fp32(depth, seed=1, num_classes=CLASSES)
        b = PR.init_resnet_fp32(depth, seed=1, num_classes=CLASSES)
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k

    def test_unsupported_depth_raises(self):
        with pytest.raises(ValueError, match="unsupported depth"):
            PR.init_resnet_fp32(77)
        with pytest.raises(ValueError, match="unsupported depth"):
            PR.quantize_resnet({}, _x(1, 0), depth=20)

    def test_plans_identical_to_jax(self):
        assert P.STAGE_PLANS == J.STAGE_PLANS
        assert P.BOTTLENECK_DEPTHS == J.BOTTLENECK_DEPTHS
        assert P.EXPANSION == J.EXPANSION

    @pytest.mark.parametrize("depth,n_blocks", [(50, 16), (101, 33),
                                                (152, 50)])
    def test_real_plan_structure(self, depth, n_blocks):
        params = PR.init_resnet_fp32(depth, seed=0, num_classes=CLASSES,
                                     small_input=True)
        model = PR.quantize_resnet(params, _x(1, 2, hw=8), depth, CLASSES,
                                   small_input=True)
        assert len(model.blocks) == n_blocks
        assert all(isinstance(b, P.QBottleneck) for b in model.blocks)
        widths = [256 * 2 ** si for si, (_, n, _) in
                  enumerate(P.STAGE_PLANS[depth]) for _ in range(n)]
        assert [b.conv3.w2d.shape[0] for b in model.blocks] == widths
        b0 = model.blocks[0]
        assert (b0.conv1.kernel, b0.conv2.kernel, b0.conv3.kernel) == \
            (1, 3, 1)
        # stage 1 downsamples channels only: 1x1 stride 1, 64 -> 256
        assert b0.downsample.stride == 1 and b0.downsample.kernel == 1
        assert b0.downsample.w2d.shape == (256, 64)
        assert sum(b.downsample is not None for b in model.blocks) == 4
        assert [b.conv2.stride for b in model.blocks if b.downsample] == \
            [1, 2, 2, 2]
        assert model.fc_w.shape == (CLASSES, 2048)

    def test_bottleneck_refuses_other_c3(self, narrow):
        blk = narrow["port"].blocks[0]
        with pytest.raises(ValueError, match="bottleneck"):
            dataclasses.replace(blk, conv3=blk.conv2)


class TestQuantize:
    def test_fold_bn_identical_to_jax(self, narrow):
        a = J.fold_all_bn(narrow["params"], stages=BOTTLENECK,
                          bottleneck=True)
        b = P.fold_all_bn(narrow["params"], stages=BOTTLENECK,
                          bottleneck=True)
        assert list(a) == list(b) and any(".conv3" in k for k in a)
        for k in a:
            assert np.array_equal(a[k], b[k]), k

    @pytest.mark.parametrize("options", [
        {}, {"calib_batch_size": 3}, {"calib_percentile": 99.9},
        {"pow2_input_scale": True}], ids=lambda o: "-".join(o) or "abs_max")
    def test_calibration_matches_jax(self, narrow, options):
        ref = (narrow["ref"] if not options else
               _quantize(J, narrow["params"], BOTTLENECK, True, **options))
        got = _quantize(P, narrow["params"], BOTTLENECK, True, **options)
        _assert_same_quantization(ref, got)
        if options.get("pow2_input_scale"):
            m, _ = np.frexp(got.s_input)
            assert m == 0.5 and got.s_input == ref.s_input

    def test_calib_batch_size_must_be_positive(self, narrow):
        with pytest.raises(ValueError, match="calib_batch_size"):
            _quantize(P, narrow["params"], BOTTLENECK, True,
                      calib_batch_size=0)


class TestForward:
    def test_bit_exact_vs_golden_and_jax_expand_fused(self, narrow):
        """Batch 128: the JAX K7 route runs only at N % 128 == 0."""
        ref = narrow["ref"]
        x = _x(128, 3)
        got = P.ResNet18Int8Module(narrow["port"], "cpu")(
            torch.from_numpy(x)).numpy()
        assert got.shape == (128, CLASSES) and got.dtype == np.float32
        jax_out = np.asarray(J.make_forward(
            ref, backend="cpu", expand_fused=True)(
                ref.as_device_params(), jnp.asarray(x)))
        golden = J.forward_golden(ref, x[:4])
        np.testing.assert_array_equal(got[:4], golden)
        np.testing.assert_array_equal(jax_out[:4], golden)
        np.testing.assert_array_equal(got, jax_out)

    def test_inv_out_equals_jax_proof(self, narrow):
        """Each bottleneck's reciprocal for K7's join is the JAX
        ``exact_inv_out_scale`` of its scales, as JAX ``make_forward``
        finds it once per block (its ``inv_of``)."""
        from resnet_accel_tpu.ops.epilogue import exact_inv_out_scale
        ref = narrow["ref"]
        mod = P.ResNet18Int8Module(narrow["port"], "cpu")
        want = [exact_inv_out_scale(b.s_main, b.s_res, b.s_out)
                for b in ref.blocks]
        assert mod.inv_out == want
        assert any(v is not None for v in want)

    def test_plain_forward_matches_forward(self, narrow):
        mod = P.ResNet18Int8Module(narrow["port"], "cpu")
        assert all("c3" in convs for convs in mod.blocks)
        x = torch.from_numpy(_x(2, 4))
        assert torch.equal(mod(x), mod.forward_plain(x))

    def test_basic_block_plan(self):
        """Depth-34-style basic blocks through the generalized init,
        quantize and forward."""
        params = J.init_resnet18_fp32(seed=2, num_classes=CLASSES,
                                      small_input=True, stages=BASIC)
        mine = P.init_resnet18_fp32(seed=2, num_classes=CLASSES,
                                    small_input=True, stages=BASIC)
        for k in params:
            assert np.array_equal(params[k], mine[k]), k
        ref = _quantize(J, params, BASIC, False)
        _assert_same_quantization(ref, _quantize(P, mine, BASIC, False))
        port = P.from_reference(ref)
        assert all(isinstance(b, P.QBlock) for b in port.blocks)
        x = _x(2, 5)
        np.testing.assert_array_equal(
            P.ResNet18Int8Module(port, "cpu")(torch.from_numpy(x)).numpy(),
            J.forward_golden(ref, x))


@pytest.fixture(scope="module")
def sparse():
    """The narrow bottleneck plan pruned at 0.7 with 16 x 16 blocks, BSR
    attached at 16 on its c1, c3 and downsample layers (mirrors the JAX
    package's sparse bottleneck test)."""
    params = J.init_resnet18_fp32(seed=0, num_classes=CLASSES,
                                  small_input=True, stages=BOTTLENECK,
                                  bottleneck=True)
    pruned = J.prune_params_blockwise(params, 0.7, block=16)
    dense = _quantize(J, pruned, BOTTLENECK, True)

    def only(prefix):
        return prefix.endswith((".c1", ".c3", ".ds"))
    ref = J.attach_bsr(dense, block=16, min_sparsity=0.3, layer_filter=only)
    x = _x(2, 6)
    jax_out = np.asarray(J.make_forward(ref, use_pallas=True,
                                        backend="cpu")(
        ref.as_device_params(), jnp.asarray(x)))
    return dict(params=params, pruned=pruned, ref=ref, x=x, jax=jax_out,
                only=only, dense=P.from_reference(dense),
                port=P.from_reference(ref))


class TestSparse:
    def test_prune_identical_to_jax(self, sparse):
        mine = P.prune_params_blockwise(sparse["params"], 0.7, block=16)
        assert list(mine) == list(sparse["pruned"])
        for k, v in sparse["pruned"].items():
            assert v.dtype == mine[k].dtype and np.array_equal(v, mine[k]), k

    def test_attach_covers_c3(self, sparse):
        want = sparse["ref"].sparsity_report()
        assert any(k.endswith(".c3") for k in want), want
        assert sparse["port"].sparsity_report() == want
        got = P.attach_bsr(sparse["dense"], block=16, min_sparsity=0.3,
                           layer_filter=sparse["only"])
        assert got.sparsity_report() == want

    def test_forward_equals_dense_and_jax(self, sparse):
        x = torch.from_numpy(sparse["x"])
        mod = P.ResNet18Int8Module(sparse["port"], "cpu")
        assert mod.blocks[0]["c3"].packed is not None
        got = mod(x).numpy()
        np.testing.assert_array_equal(
            got, P.ResNet18Int8Module(sparse["dense"], "cpu")(x).numpy())
        np.testing.assert_array_equal(got, sparse["jax"])
        assert torch.equal(mod.forward_plain(x), mod(x))

    def test_npz_round_trip_with_bsr(self, sparse, tmp_path):
        port = sparse["port"]
        path = str(tmp_path / "bottleneck.npz")
        port.save_npz(path)
        back = P.ResNet18Int8.load_npz(path)
        assert [type(b) for b in back.blocks] == [type(b) for b in port.blocks]
        assert back.sparsity_report() == port.sparsity_report()
        for (name, a), (_, b) in zip(port.named_convs(), back.named_convs()):
            np.testing.assert_array_equal(a.w2d, b.w2d, err_msg=name)
            assert (a.bsr is None) == (b.bsr is None), name
        for a, b in zip(port.blocks, back.blocks):
            assert (a.s_in, a.s_main, a.s_res, a.s_out) == \
                (b.s_in, b.s_main, b.s_res, b.s_out)
        np.testing.assert_array_equal(
            P.ResNet18Int8Module(back, "cpu")(
                torch.from_numpy(sparse["x"])).numpy(), sparse["jax"])


def test_basic_block_npz_still_loads(tmp_path):
    """A basic-block file holds no c3 arrays, so it loads as before."""
    stages = [(16, 1, 1)]
    params = P.init_resnet18_fp32(seed=0, num_classes=4, small_input=True,
                                  stages=stages)
    model = P.quantize_resnet18(params, _x(1, 7, hw=8), 4, small_input=True,
                                stages=stages)
    path = str(tmp_path / "basic.npz")
    model.save_npz(path)
    with np.load(path) as z:
        assert not any(".c3." in k for k in z.files)
    back = P.ResNet18Int8.load_npz(path)
    assert all(type(b) is P.QBlock for b in back.blocks)
    x = torch.from_numpy(_x(1, 8, hw=8))
    assert torch.equal(P.ResNet18Int8Module(back, "cpu")(x),
                       P.ResNet18Int8Module(model, "cpu")(x))


class TestCli:
    def test_infer_resnet50_cpu(self, tmp_path, capsys):
        path = tmp_path / "x.npy"
        np.save(path, _x(2, 9, hw=32))
        rc = cli.main(["infer", "--model", "resnet", "--depth", "50",
                       "--input", str(path), "--device", "cpu",
                       "--num-classes", "10", "--small-input"])
        out = capsys.readouterr().out
        assert rc == 0
        assert out.count("sample ") == 2 and "images/s on cpu" in out

    def test_depth_ignored_with_another_model_warns(self, tmp_path, capsys):
        path = tmp_path / "x.npy"
        np.save(path, _x(1, 10, hw=8))
        rc = cli.main(["infer", "--model", "resnet18", "--depth", "34",
                       "--input", str(path), "--device", "cpu",
                       "--num-classes", "4", "--small-input"])
        captured = capsys.readouterr()
        assert rc == 0 and captured.out.count("sample ") == 1
        assert "--depth 34 is ignored" in captured.err
