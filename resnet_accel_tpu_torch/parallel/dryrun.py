"""The multi-device dry run: every parallel program once, in one world.

Counterpart of ``__graft_entry__.py``'s ``dryrun_multichip``, which runs
the JAX programs over virtual CPU devices: the same sequence of programs,
at the same tiny shapes and with the same asserts, here in the ranks of a
world that ``launch.run_world`` spawns (gloo on the CPU; on cards, NCCL
with a card a rank, or gloo with the ranks sharing a card).

    python -m resnet_accel_tpu_torch.parallel.dryrun 4 --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def _dryrun_body(rank: int, world: int, device: str) -> str:
    """The dry run in one rank; returns its summary line (every rank the
    same line; a failed check raises)."""
    from resnet_accel_tpu_torch.models.lm import TransformerLMInt8
    from resnet_accel_tpu_torch.models.moe import MoEBlockInt8
    from resnet_accel_tpu_torch.models.resnet18 import (init_resnet18_fp32,
                                                        quantize_resnet18)
    from resnet_accel_tpu_torch.models.transformer import (
        TransformerBlockInt8, TransformerBlockInt8Module)
    from resnet_accel_tpu_torch.parallel.collectives import all_gather
    from resnet_accel_tpu_torch.parallel.combined import (
        make_combined_forward, make_combined_mesh, make_combined_train_step)
    from resnet_accel_tpu_torch.parallel.experts import make_ep_moe_forward
    from resnet_accel_tpu_torch.parallel.heads import (
        make_tp_decode_step, make_tp_lm_generate, make_tp_transformer_forward)
    from resnet_accel_tpu_torch.parallel.mesh import (batch_sharding,
                                                      make_mesh, named_mesh)
    from resnet_accel_tpu_torch.parallel.pipeline import (
        make_pipeline_forward, mnist_pipeline_stages,
        transformer_pipeline_stages)
    from resnet_accel_tpu_torch.parallel.sequence import \
        make_sp_transformer_forward
    from resnet_accel_tpu_torch.parallel.sharded import (
        make_data_parallel_forward, make_sharded_train_step)
    from resnet_accel_tpu_torch.runtime.paged import PagedKVBatcher
    from resnet_accel_tpu_torch.train.mnist import (init_mnist_params,
                                                    mnist_forward_fp32)

    n = world
    tp = 2 if n % 2 == 0 else 1
    dp = n // tp
    mesh = make_mesh(dp=dp, tp=tp, device=device)

    # --- full training step: dp-sharded batch, tp-sharded fc1, Adam ----
    init_fn, step_fn, shard_batch = make_sharded_train_step(mesh,
                                                            device=device)
    params, opt = init_fn(init_mnist_params(seed=0))
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2 * dp, 1, 28, 28)).astype(np.float32)
    y = rng.integers(0, 10, 2 * dp).astype(np.int32)
    params, opt, loss = step_fn(params, opt, *shard_batch(x, y))
    assert np.isfinite(loss), "sharded train step produced NaN"

    # --- dp-sharded INT8 serving forward --------------------------------
    fp32 = init_resnet18_fp32(seed=1, num_classes=10, small_input=True)
    calib = rng.normal(0, 1, (2, 3, 32, 32)).astype(np.float32)
    model = quantize_resnet18(fp32, calib, 10, small_input=True)
    fwd, mod, put_batch = make_data_parallel_forward(model, mesh, device)
    xb = rng.normal(0, 1, (dp * tp, 3, 32, 32)).astype(np.float32)
    out = fwd(mod, put_batch(xb))
    assert tuple(out.shape) == (dp * tp, 10)

    # --- pipeline parallelism: general stage-list GPipe over 'pp' -------
    pp_mesh = named_mesh({"pp": 2}, device)
    xp = rng.normal(0, 1, (4, 1, 28, 28)).astype(np.float32)
    if pp_mesh is not None:
        pp_fwd = make_pipeline_forward(
            pp_mesh, mnist_pipeline_stages(init_mnist_params(seed=0), 2,
                                           device), microbatch=2)
        with torch.inference_mode():
            logits = pp_fwd(torch.as_tensor(xp, device=device))
        assert tuple(logits.shape) == (4, 10)
    pp_deep = min(4, n)
    xt = rng.normal(0, 1, (4, 64)).astype(np.float32)
    if pp_deep >= 2:
        pp4_mesh = named_mesh({"pp": pp_deep}, device)
        if pp4_mesh is not None:
            t_stages = transformer_pipeline_stages(
                [TransformerBlockInt8Module(TransformerBlockInt8.from_random(
                    seed=i, d_model=64, n_heads=4, d_ff=128), device)
                 for i in range(pp_deep)], n_stages=pp_deep)
            pp4_fwd = make_pipeline_forward(pp4_mesh, t_stages, microbatch=2)
            with torch.inference_mode():
                tt = pp4_fwd(torch.as_tensor(xt, device=device))
            assert tuple(tt.shape) == (4, 64)

    # --- sequence parallelism: sp-sharded transformer encoder block ----
    sp_n = min(4, n)
    sp_mesh = named_mesh({"sp": sp_n}, device)
    tblock = TransformerBlockInt8.from_random(seed=0)
    xs = rng.normal(0, 1, (4 * sp_n, 128)).astype(np.float32)
    if sp_mesh is not None:
        sp_fwd = make_sp_transformer_forward(sp_mesh, tblock, device)
        ys = all_gather(sp_fwd(batch_sharding(torch.as_tensor(xs), sp_mesh,
                                              "sp")), sp_mesh, "sp")
        assert tuple(ys.shape) == (4 * sp_n, 128)

    # --- head (tensor) parallelism: tp-sharded transformer attention ---
    tpa_n = 2
    tpa_mesh = named_mesh({"tp": tpa_n}, device)
    xa = rng.normal(0, 1, (8, 128)).astype(np.float32)
    dec_x = rng.normal(0, 1, (6, 128)).astype(np.float32)
    if tpa_mesh is not None:
        w = make_tp_transformer_forward(tpa_mesh, tblock, device)(xa)
        assert tuple(w.shape) == (8, 128)

        # --- tp-sharded CACHED decode: each rank holds its heads' KV
        # slice, one int32 psum per projection ------------------------
        dec_scales = tblock.calibrate_scales(dec_x)
        dec_init, dec_step = make_tp_decode_step(
            tpa_mesh, tblock, dec_scales, max_len=8, device=device)
        dec_cache = dec_init()
        for t in range(3):
            y_t, dec_cache = dec_step(dec_cache, dec_x[t:t + 1])
        assert tuple(y_t.shape) == (1, 128)
        assert dec_cache["len"] == 3

    # --- FULL-LM tp-sharded serving, token-exact vs the single-device
    # model; then the dp x tp batched-serving composition --------------
    lm = TransformerLMInt8.from_random(
        seed=3, vocab=31, d_model=64, n_heads=4, n_layers=2, d_ff=128,
        max_len=16, sparsity=0.5)
    lm_scales = lm.calibrate(rng.integers(0, 31, 12))
    lm_prompt = np.array([5, 9, 2, 11], np.int32)
    lm_want = lm.generate(lm_prompt, 4, lm_scales, parallel_prefill=False,
                          device=device)
    if tpa_mesh is not None:
        lm_gen = make_tp_lm_generate(tpa_mesh, lm, lm_scales, n_new=4,
                                     device=device)
        np.testing.assert_array_equal(lm_gen(lm_prompt), lm_want)
    lm_serve = ""
    if n >= 4:
        dt_mesh = named_mesh({"dp": 2, "tp": 2}, device)
        bprompts = np.stack([lm_prompt, np.array([3, 3, 8, 1], np.int32)])
        if dt_mesh is not None:
            bgen = make_tp_lm_generate(dt_mesh, lm, lm_scales, n_new=4,
                                       batched=True, device=device)
            btoks = bgen(bprompts)
            for b in range(2):
                np.testing.assert_array_equal(btoks[b], lm.generate(
                    bprompts[b], 4, lm_scales, parallel_prefill=False,
                    device=device))
        lm_serve = " lm-serve=dp2xtp2(token-exact)"

    # --- tp-sharded PRODUCTION paged engine: the PagedKVBatcher itself
    # over a 'tp' mesh, token-exact vs the single-device engine ---------
    pg_reqs = [([5, 9, 2, 11], 4), ([3, 3, 8], 3)]
    if tpa_mesh is not None:
        pg_single = PagedKVBatcher(lm, lm_scales, slots=2, page=4,
                                   pool_pages=9, device=device)
        pg_tp = PagedKVBatcher(lm, lm_scales, slots=2, page=4, pool_pages=9,
                               tp_mesh=tpa_mesh, device=device)
        sr = [pg_single.submit(p, k) for p, k in pg_reqs]
        tr = [pg_tp.submit(p, k) for p, k in pg_reqs]
        sres, tres = pg_single.run(), pg_tp.run()
        for a, b in zip(sr, tr):
            assert sres[a] == tres[b], "tp paged engine diverged"

    # --- expert parallelism: ep-sharded MoE block -----------------------
    ep_n = 2
    ep_mesh = named_mesh({"ep": ep_n}, device)
    moe = MoEBlockInt8.from_random(n_experts=4, seed=0)
    xe = rng.normal(0, 1, (16, 128)).astype(np.float32)
    if ep_mesh is not None:
        z = make_ep_moe_forward(ep_mesh, moe, device)(xe)
        assert tuple(z.shape) == (16, 128)

    # --- COMBINED dp x pp x tp: one 3-axis mesh program, fwd + train ----
    combined = ""
    if n >= 8:
        c_mesh = make_combined_mesh(2, 2, 2, device)
        cx = rng.normal(0, 1, (8, 1, 28, 28)).astype(np.float32)
        cy = rng.integers(0, 10, 8).astype(np.int32)
        if c_mesh is not None:
            c_init, c_step, c_shard = make_combined_train_step(
                c_mesh, microbatch=2, device=device)
            c_params, c_opt = c_init(init_mnist_params(seed=0))
            c_params, c_opt, c_loss = c_step(c_params, c_opt,
                                             *c_shard(cx, cy))
            assert np.isfinite(c_loss), "combined-mesh step NaN"
            # the composed forward against the unsharded model
            ref_p = {k: torch.as_tensor(v, device=device)
                     for k, v in init_mnist_params(seed=0).items()}
            with torch.inference_mode():
                got = all_gather(make_combined_forward(c_mesh, 2)(
                    ref_p, c_shard(cx, cy)[0]), c_mesh, "dp")
                want = mnist_forward_fp32(ref_p, torch.as_tensor(
                    cx, device=device))
            np.testing.assert_allclose(got.cpu().numpy(),
                                       want.cpu().numpy(), rtol=1e-4,
                                       atol=1e-4)
        combined = " combined=dp2xpp2xtp2(fwd+train)"

    return (f"dryrun_multichip OK: dp={dp} tp={tp} "
            f"(+tp-attention={tpa_n} +tp-decode={tpa_n} "
            f"+tp-lm-generate={tpa_n}(token-exact) "
            f"+paged-tp={tpa_n}(token-exact)) "
            f"pp=2/{pp_deep} sp={sp_n} ep={ep_n}{lm_serve}{combined} "
            f"all exercised; train loss {loss:.4f}, "
            f"serve out {tuple(out.shape)}")


def dryrun_multichip(n_devices: int, device="cuda",
                     backend=None, timeout_s: float = 300.0) -> str:
    """Every parallel program once in a world of ``n_devices`` ranks on
    ``device`` (``launch.run_world``'s backends); prints and returns the
    summary line."""
    from resnet_accel_tpu_torch.parallel.launch import run_world
    from resnet_accel_tpu_torch.runtime.backend import resolve_device
    dev = resolve_device(device)
    lines = run_world(_dryrun_body, n_devices, device=dev, backend=backend,
                      args=(dev.type,), timeout_s=timeout_s)
    if len(set(lines)) != 1:
        raise RuntimeError(f"ranks disagree: {lines}")
    print(lines[0])
    return lines[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m resnet_accel_tpu_torch.parallel.dryrun")
    ap.add_argument("n_devices", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--backend", default=None, choices=["gloo", "nccl"])
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device, args.backend)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
