"""PyTorch port: block-sparse ResNet-18 serving against the JAX package.

The fixture mirrors tests/test_sparse_resnet.py: CIFAR geometry, 10
classes, weights block-pruned at 0.7 with 64 x 64 blocks, BSR attached at
64 x 64.  Pruning, the attached BSR and the sparsity report are identical
to the JAX package's; the sparse logits (the zero-skip GEMM's plain version
on the CPU) are bit-identical (tolerance 0) to the JAX
``make_forward(use_pallas=True)``, to the golden ``forward_golden`` and to
the port's dense forward of the same pruned model.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from resnet_accel_tpu.models import resnet18 as J
from resnet_accel_tpu.runtime import InferenceEngine as JaxEngine
from resnet_accel_tpu_torch.models import resnet18 as P
from resnet_accel_tpu_torch.runtime.engine import InferenceEngine

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def models():
    params = J.init_resnet18_fp32(seed=0, num_classes=10, small_input=True)
    pruned = J.prune_params_blockwise(params, sparsity=0.7, block=64)
    calib = np.random.default_rng(1).normal(
        0, 1, (2, 3, 32, 32)).astype(np.float32)
    dense = J.quantize_resnet18(pruned, calib, 10, small_input=True)
    sparse = J.attach_bsr(dense, block=64, min_sparsity=0.25, chunk=8)
    return dict(params=params, dense=dense, sparse=sparse,
                port_dense=P.from_reference(dense),
                port_sparse=P.from_reference(sparse))


@pytest.fixture(scope="module")
def reference(models):
    """The JAX sparse forward and the golden on two images (computed once:
    the JAX forward takes seconds to trace on the CPU)."""
    sparse = models["sparse"]
    x = np.random.default_rng(2).normal(0, 1, (2, 3, 32, 32)).astype(
        np.float32)
    jax_out = np.asarray(J.make_forward(sparse, use_pallas=True)(
        sparse.as_device_params(), jnp.asarray(x)))
    return dict(x=x, jax=jax_out, golden=J.forward_golden(sparse, x))


def _assert_same_bsr(a, b, name):
    assert (a is None) == (b is None), name
    if a is not None:
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype and np.array_equal(x, y), name
            else:
                assert x == y, (name, f.name)


class TestPrune:
    @pytest.mark.parametrize("small_input,block,sparsity", [
        (True, 64, 0.7), (False, 128, 0.7), (False, 128, 0.5)])
    def test_pruned_params_identical(self, small_input, block, sparsity):
        params = J.init_resnet18_fp32(seed=0, num_classes=10,
                                      small_input=small_input)
        a = J.prune_params_blockwise(params, sparsity=sparsity, block=block)
        b = P.prune_params_blockwise(params, sparsity=sparsity, block=block)
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        assert np.array_equal(b["conv1.weight"], params["conv1.weight"])

    def test_sparsity_report_identical(self, models):
        want = models["sparse"].sparsity_report()
        assert len(want) >= 8 and "stem" not in want
        assert models["port_sparse"].sparsity_report() == want
        attached = P.attach_bsr(models["port_dense"], block=64)
        assert attached.sparsity_report() == want
        assert models["port_dense"].sparsity_report() == {}


class TestAttach:
    def test_from_reference_carries_every_bsr(self, models):
        port, ref = models["port_sparse"], models["sparse"]
        n = 0
        for (name, qp), (_, qj) in zip(port.named_convs(),
                                       ref.named_convs()):
            assert (qp.bsr is None) == (qj.bsr is None), name
            if qj.bsr is not None:
                n += 1
                assert (qp.bsr.block_h, qp.bsr.block_w) == (64, 64)
                assert qp.bsr.nnz_blocks == qj.bsr.nnz_source, name
                assert qp.bsr.total_blocks == qj.bsr.total_source, name
                np.testing.assert_array_equal(qp.bsr.to_dense(), qp.w2d)
        assert n == len(ref.sparsity_report())

    def test_from_reference_checks_block_counts(self, models):
        ref = models["sparse"]
        blk = ref.blocks[1]
        bad = dataclasses.replace(blk.conv1.bsr,
                                  nnz_source=blk.conv1.bsr.nnz_source + 1)
        broken = dataclasses.replace(ref, blocks=[
            *ref.blocks[:1], dataclasses.replace(
                blk, conv1=dataclasses.replace(blk.conv1, bsr=bad)),
            *ref.blocks[2:]])
        with pytest.raises(ValueError, match="blocks"):
            P.from_reference(broken)

    @pytest.mark.parametrize("layer_filter", [
        None, lambda prefix: prefix.endswith(".c1")])
    def test_attach_bsr_identical_to_jax(self, models, layer_filter):
        want = P.from_reference(J.attach_bsr(
            models["dense"], block=64, layer_filter=layer_filter))
        got = P.attach_bsr(models["port_dense"], block=64,
                           layer_filter=layer_filter)
        for (name, a), (_, b) in zip(got.named_convs(), want.named_convs()):
            _assert_same_bsr(a.bsr, b.bsr, name)


class TestForward:
    def test_bit_exact_vs_jax_golden_and_dense(self, models, reference):
        x = torch.from_numpy(reference["x"])
        got = P.ResNet18Int8Module(models["port_sparse"], "cpu")(x).numpy()
        dense = P.ResNet18Int8Module(models["port_dense"], "cpu")(x).numpy()
        np.testing.assert_array_equal(got, reference["golden"])
        np.testing.assert_array_equal(reference["jax"], reference["golden"])
        np.testing.assert_array_equal(dense, reference["golden"])

    def test_plain_forward_matches_forward(self, models, reference):
        mod = P.ResNet18Int8Module(models["port_sparse"], "cpu")
        assert any(c.packed is not None for blk in mod.blocks
                   for c in blk.values())
        x = torch.from_numpy(reference["x"])
        assert torch.equal(mod(x), mod.forward_plain(x))

    def test_every_layer_sparse(self, models, reference):
        """min_sparsity 0 gives every layer BSR, the stem included (which
        still runs dense); logits unchanged."""
        model = P.attach_bsr(models["port_dense"], block=64,
                             min_sparsity=0.0)
        assert all(qc.bsr is not None for _, qc in model.named_convs())
        got = P.ResNet18Int8Module(model, "cpu")(
            torch.from_numpy(reference["x"]))
        np.testing.assert_array_equal(got.numpy(), reference["golden"])

    def test_imagenet_geometry(self):
        """7x7 stem and max pool, a sparse downsample: sparse logits equal
        the dense forward's and the golden's."""
        stages = [(64, 1, 1), (128, 1, 2)]
        params = P.prune_params_blockwise(
            J.init_resnet18_fp32(seed=0, num_classes=10, stages=stages),
            sparsity=0.7, block=64)
        x = np.random.default_rng(4).normal(0, 1, (2, 3, 64, 64)).astype(
            np.float32)
        ref = J.quantize_resnet18(params, x, 10, stages=stages)
        dense = P.from_reference(ref)
        sparse = P.attach_bsr(dense, block=64)
        assert "b1.ds" in sparse.sparsity_report()
        xt = torch.from_numpy(x)
        got = P.ResNet18Int8Module(sparse, "cpu")(xt).numpy()
        np.testing.assert_array_equal(
            got, P.ResNet18Int8Module(dense, "cpu")(xt).numpy())
        np.testing.assert_array_equal(got[:1], J.forward_golden(ref, x[:1]))

    def test_npz_round_trip_with_bsr(self, models, reference, tmp_path):
        port = models["port_sparse"]
        path = str(tmp_path / "sparse.npz")
        port.save_npz(path)
        back = P.ResNet18Int8.load_npz(path)
        assert back.sparsity_report() == port.sparsity_report()
        for (name, a), (_, b) in zip(port.named_convs(), back.named_convs()):
            _assert_same_bsr(a.bsr, b.bsr, name)
            np.testing.assert_array_equal(a.w2d, b.w2d)
        x = torch.from_numpy(reference["x"])
        np.testing.assert_array_equal(
            P.ResNet18Int8Module(back, "cpu")(x).numpy(), reference["golden"])


class TestEngine:
    def test_get_model_sparsity(self, models, reference):
        eng = InferenceEngine(models["port_sparse"], device="cpu")
        want = JaxEngine(models["sparse"], J.make_forward,
                         backend="cpu").get_model_sparsity()
        rep = eng.get_model_sparsity()
        assert rep == want and all(isinstance(v, float)
                                   for v in rep.values())
        assert InferenceEngine(models["port_dense"],
                               device="cpu").get_model_sparsity() == {}
        res = eng.run_inference(reference["x"])
        np.testing.assert_array_equal(res.logits, reference["golden"])
