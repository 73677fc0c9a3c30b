"""PyTorch port: the INT8 block-sparse decoder LM against the JAX package's,
on the CPU, at the size of tests/test_lm.py (vocab 32, d_model 64, 4 heads,
d_ff 128, 2 layers, max_len 16, sparsity 0.7, 8 x 8 blocks, seed 3).

Tolerances, each with its reason:
- 0 (exact) for the numpy copies (masks, positions, golden GEMM,
  ``from_random``, ``calibrate``, ``forward_golden``) and for the int32
  gather-BSR products: the same numpy code, and integer sums.
- rtol = atol = 1e-4 for float32 logits: the same static int8 scales give
  the same int8 activations, and float32 LayerNorm, softmax and the readout
  sum in another order than XLA's (the JAX package holds its own decode and
  forward paths to the same 1e-4, tests/test_lm.py).
- Greedy tokens: equal.
"""

import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from resnet_accel_tpu import golden as j_golden
from resnet_accel_tpu.models.lm import TransformerLMInt8 as JLM
from resnet_accel_tpu.models.lm import sinusoidal_positions as j_sinusoidal
from resnet_accel_tpu.ops.bsr_matmul import (
    bsr_matmul_wt_xla as j_bsr_matmul_wt_xla)
from resnet_accel_tpu.sparse.fixtures import (
    create_sparse_mask as j_create_sparse_mask)
from resnet_accel_tpu_torch import cli, golden
from resnet_accel_tpu_torch.models.lm import (
    TransformerLMInt8,
    TransformerLMInt8Module,
    from_reference,
    sinusoidal_positions,
)
from resnet_accel_tpu_torch.models.transformer import PROJECTIONS
from resnet_accel_tpu_torch.ops import bsr_matmul_wt_xla, pack_gather_bsr
from resnet_accel_tpu_torch.sparse import build_bsr_int8_direct
from resnet_accel_tpu_torch.sparse.fixtures import create_sparse_mask

torch.set_num_threads(1)

CFG = dict(vocab=32, d_model=64, n_heads=4, d_ff=128, n_layers=2,
           max_len=16, sparsity=0.7, block=8, seed=3)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def jlm():
    return JLM.from_random(**CFG)


@pytest.fixture(scope="module")
def toks():
    return np.random.default_rng(7).integers(0, 32, 10).astype(np.int32)


@pytest.fixture(scope="module")
def jscales(jlm, toks):
    return jlm.calibrate(toks)


@pytest.fixture(scope="module")
def lm(jlm):
    return from_reference(jlm)


@pytest.fixture(scope="module")
def mod(lm):
    return lm.module("cpu")


# ------------------------------------------------------ numpy copies, exact

@pytest.mark.parametrize("shape,block,sparsity,seed", [
    ((64, 64), 8, 0.7, 4), ((128, 64), 8, 0.8, 105), ((30, 50), 8, 0.5, 0),
    ((512, 1024), 8, 0.8, 6)])
def test_create_sparse_mask_equals_jax(shape, block, sparsity, seed):
    np.testing.assert_array_equal(
        create_sparse_mask(shape, block, sparsity, seed=seed),
        j_create_sparse_mask(shape, block, sparsity, seed=seed))


@pytest.mark.parametrize("max_len,d_model", [(16, 64), (1024, 512)])
def test_sinusoidal_positions_equal_jax(max_len, d_model):
    np.testing.assert_array_equal(sinusoidal_positions(max_len, d_model),
                                  j_sinusoidal(max_len, d_model))


@pytest.mark.parametrize("block,N,K", [(8, 40, 72), (14, 30, 50)])
def test_golden_bsr_gemm_equals_jax(block, N, K):
    rng = np.random.default_rng(block)
    W = rng.integers(-128, 128, (N, K)).astype(np.int8)
    W *= create_sparse_mask((N, K), block, 0.6, seed=1).astype(np.int8)
    bsr = build_bsr_int8_direct(W, block)
    A = rng.integers(-128, 128, (5, K)).astype(np.int8)
    args = (A, bsr.data, bsr.row_ptr, bsr.col_idx, block, block)
    got = golden.bsr_matmul_int8_wt(*args, N=N)
    np.testing.assert_array_equal(got, j_golden.bsr_matmul_int8_wt(*args,
                                                                   N=N))
    np.testing.assert_array_equal(got, A.astype(np.int64) @ W.T)


def _arrays(model):
    """Every array of a port or JAX LM, by name."""
    out = {k: np.asarray(getattr(model, k))
           for k in ("embed", "pos", "lnf_g", "lnf_b")}
    for i, blk in enumerate(model.blocks):
        for k in ("ln1_g", "ln1_b", "ln2_g", "ln2_b"):
            out[f"b{i}.{k}"] = np.asarray(getattr(blk, k))
        out[f"b{i}.n_heads"] = np.asarray(blk.n_heads)
        for name in PROJECTIONS:
            p = getattr(blk, name)
            for k in ("data", "row_ptr", "col_idx"):
                out[f"b{i}.{name}.{k}"] = np.asarray(getattr(p.bsr, k))
            out[f"b{i}.{name}.scales"] = np.asarray(p.scales)
            out[f"b{i}.{name}.bias"] = np.asarray(p.bias)
    return out


def _assert_same_arrays(a, b):
    a, b = _arrays(a), _arrays(b)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_from_random_equals_jax(jlm, lm):
    _assert_same_arrays(TransformerLMInt8.from_random(**CFG), jlm)
    _assert_same_arrays(lm, jlm)


def test_calibrate_equals_jax(lm, toks, jscales):
    got = lm.calibrate(toks)
    assert got == jscales
    assert TransformerLMInt8.from_random(**CFG).calibrate(toks) == jscales


def test_forward_golden_equals_jax(lm, jlm, toks):
    np.testing.assert_array_equal(lm.forward_golden(toks),
                                  jlm.forward_golden(toks))


# ---------------------------------------------- gather-BSR products, exact

@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("name", PROJECTIONS)
def test_bsr_matmul_wt_xla_bit_exact(lm, jlm, layer, name):
    jp = getattr(jlm.blocks[layer], name)
    p = getattr(lm.blocks[layer], name)
    a = np.random.default_rng(layer * 10 + PROJECTIONS.index(name)).integers(
        -128, 128, (7, p.d_in)).astype(np.int8)
    g = pack_gather_bsr(p.bsr, "cpu")
    np.testing.assert_array_equal(g.blocks.numpy(),
                                  np.asarray(jp.gather.blocks))
    np.testing.assert_array_equal(g.gather_idx.numpy(),
                                  np.asarray(jp.gather.gather_idx))
    got = bsr_matmul_wt_xla(torch.from_numpy(a), g)
    assert got.dtype == torch.int32
    want = np.asarray(j_bsr_matmul_wt_xla(jnp.asarray(a), jp.gather))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), golden.bsr_matmul_int8_wt(
        a, p.bsr.data, p.bsr.row_ptr, p.bsr.col_idx, 8, 8, N=p.d_out))


def test_bsr_matmul_wt_xla_extreme_values_exact():
    """All -128 at K = 1024 (the serving LM's w2): every sum is 2^24, the
    edge of float32's exact integers; the float64 product keeps it."""
    W = np.full((16, 1024), -128, np.int8)
    g = pack_gather_bsr(build_bsr_int8_direct(W, 8), "cpu")
    a = torch.full((3, 1024), -128, dtype=torch.int8)
    got = bsr_matmul_wt_xla(a, g)
    assert torch.equal(got, torch.full((3, 16), 2 ** 24, dtype=torch.int32))


# ------------------------------------------------------ forward and decode

@pytest.mark.parametrize("flash", [False, True])
def test_forward_matches_jax(mod, jlm, toks, jscales, flash):
    got = mod.forward(toks, jscales, flash=flash).numpy()
    want = np.asarray(jlm.forward(jnp.asarray(toks), jscales, flash=flash))
    assert got.shape == (10, 32)
    np.testing.assert_allclose(got, want, **TOL)


def test_forward_dynamic_scales_match_jax_and_golden(mod, jlm, lm, toks):
    """Dynamic per-sequence scales (no calibration): within 1e-4 of the JAX
    forward, and within the 2e-3 that tests/test_lm.py allows the JAX
    forward against the golden."""
    got = mod.forward(toks).numpy()
    np.testing.assert_allclose(got, np.asarray(jlm.forward(
        jnp.asarray(toks))), **TOL)
    np.testing.assert_allclose(got, lm.forward_golden(toks), rtol=2e-3,
                               atol=2e-3)


def test_batched_forward_rows_equal_single(mod, jscales):
    batch = np.random.default_rng(8).integers(0, 32, (3, 10))
    out = mod.forward(batch, jscales, flash=True).numpy()
    for i in range(3):
        np.testing.assert_allclose(out[i], mod.forward(
            batch[i], jscales, flash=True).numpy(), rtol=1e-6, atol=1e-6)


def test_decode_steps_match_jax(mod, jlm, toks, jscales):
    caches, jcaches = mod.init_caches(), jlm.init_caches()
    for t in toks:
        logits, caches = mod.decode_step(caches, int(t), jscales)
        jlogits, jcaches = jlm.decode_step(jcaches, jnp.int32(t), jscales)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **TOL)
    assert caches[0]["len"] == len(toks)
    np.testing.assert_allclose(caches[1]["k"].numpy(),
                               np.asarray(jcaches[1]["k"]), **TOL)


def test_decode_past_max_len_raises(mod, jscales):
    caches = mod.init_caches()
    for c in caches:
        c["len"] = 16
    with pytest.raises(ValueError, match="exceeds max_len"):
        mod.decode_step(caches, 0, jscales)


# -------------------------------------------------------------- generate

@pytest.mark.parametrize("parallel_prefill", [True, False])
@pytest.mark.parametrize("flash", [False, True])
def test_generate_matches_jax(lm, jlm, toks, jscales, parallel_prefill,
                              flash):
    prompt = toks[:6]
    got = lm.generate(prompt, 8, jscales, parallel_prefill=parallel_prefill,
                      flash=flash, device="cpu")
    want = np.asarray(jlm.generate(jnp.asarray(prompt), 8, jscales,
                                   parallel_prefill=parallel_prefill,
                                   flash=flash))
    assert got.dtype == np.int32 and got.shape == (8,)
    np.testing.assert_array_equal(got, want)


def test_batched_generate_matches_jax_and_single_rows(mod, jlm, toks,
                                                      jscales):
    prompts = np.stack([toks[:4], toks[2:6], toks[1:5]])
    got = mod.generate(prompts, 5, jscales, flash=True, batched=True)
    assert got.shape == (3, 5)
    np.testing.assert_array_equal(got, np.asarray(jlm.generate(
        jnp.asarray(prompts), 5, jscales, flash=True, batched=True)))
    for i in range(3):
        np.testing.assert_array_equal(
            got[i], mod.generate(prompts[i], 5, jscales, flash=True))


def test_generate_rejects_overlong(mod, jscales):
    with pytest.raises(ValueError, match="exceeds"):
        mod.generate(np.zeros(14, np.int32), 5, jscales)
    with pytest.raises(ValueError, match="expected"):
        mod.generate(np.zeros((2, 3), np.int32), 2, jscales)


def test_npz_round_trip(lm, toks, jscales, tmp_path):
    path = str(tmp_path / "lm.npz")
    lm.save_npz(path)
    back = TransformerLMInt8.load_npz(path)
    _assert_same_arrays(back, lm)
    np.testing.assert_array_equal(
        back.generate(toks[:5], 6, jscales, device="cpu"),
        lm.generate(toks[:5], 6, jscales, device="cpu"))


def test_cuda_without_card_raises(lm):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        TransformerLMInt8Module(lm, "cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        lm.generate(np.zeros(3, np.int32), 2, [{}] * 2)


# ------------------------------------------------------------------- CLI

def _generated(out: str):
    lines = [ln for ln in out.splitlines() if ln.startswith("generated:")]
    assert len(lines) == 1, out
    return lines[0]


@pytest.mark.parametrize("flags", [
    ["--n-new", "4", "--layers", "1", "--d-model", "64", "--heads", "2",
     "--max-len", "16", "--prompt", "1,2"],
    ["--n-new", "6", "--layers", "2", "--d-model", "32", "--heads", "2",
     "--vocab", "37", "--max-len", "24", "--sparsity", "0.5", "--seed", "5",
     "--prompt", "3,14,15,9,2,6", "--flash"]])
def test_cli_generate_cpu_matches_jax(capsys, flags):
    from resnet_accel_tpu.cli import main as j_main
    assert cli.main(["generate", *flags, "--device", "cpu"]) == 0
    first = _generated(capsys.readouterr().out)
    assert cli.main(["generate", *flags, "--device", "cpu"]) == 0
    assert _generated(capsys.readouterr().out) == first
    old = sys.argv
    try:
        sys.argv = ["prog", "generate", *flags]
        assert j_main() == 0
    finally:
        sys.argv = old
    assert _generated(capsys.readouterr().out) == first


def test_cli_generate_prompt_too_long_exits():
    with pytest.raises(SystemExit):
        cli.main(["generate", "--n-new", "20", "--max-len", "8",
                  "--prompt", "1,1,1,1,1", "--device", "cpu"])


def test_cli_device_defaults_to_cuda():
    p = cli.build_parser()
    for argv in (["infer", "--input", "x.npy"], ["bench"], ["generate"]):
        assert p.parse_args(argv).device == "cuda"
