"""Kernel A/B timings on the card: K1-K5, K7, K8 and K10 at served shapes.

Their times, for an A/B of two checkouts of this package in one call on
the card.

    python resnet_accel_tpu_torch/kernel_ab.py --repo P --repo C --repo C \\
        --repo P [--iters 20] [--cases K1,K2]

Each ``--repo`` is the root of a checkout (the directory that holds
``resnet_accel_tpu_torch/``).  Each runs in a process of its own, in the
order given (parent, change, change, parent compares two commits within
one call), builds that checkout's kernels and prints one JSON line a case:
``{"repo", "case", "ms", "plan"}`` with the median device time over
``--iters`` runs (CUDA events behind a spin of the card, as
``chip_smoke.py`` times), then a line with each case's ``torch._int_mm``
time (cuBLAS's dense int8 GEMM, plus the bias for K3) where cuBLAS takes
the shape (and SDPA's for K5).  The data are seeded: int8 activations and
weights, block masks drawn at the stated sparsity, normal q, k, v.

The cases (``--cases`` keeps those whose name starts with one of the
prefixes given): K1 at ResNet-18's stem, batch 128, 224 x 224 (normal
fp32 images, int8 weights; the packed weight where the checkout has
``pack_stem_weight``, as its model serves it); K10 at the same stem on
those images quantized, pooled and unpooled (the packed weight where the
checkout's K10 takes it; ``--cases K1`` keeps K10 too); K3 at ResNet-18's and
ResNet-50's fc (M 128, K 512 and 2048, N
1000, int32) and the MNIST CNN's dense fc1 (K 9216, N 128, requant and
ReLU) and fc2 (K 128, N 10); K4 at 128 x 128 blocks at the MNIST fc1
(0.9), the GEMM sweep's M 512, N = K = 2048 and 4096 (0.7, 0.9) and the
pruned ResNet-18's 18 sparse convs at batch 128 (0.7; im2col shapes,
summed); K4 at 14 x 14 (the small-block path where the checkout has it,
else ``mma_sync``) at the MNIST fc1 (its 128 x 128 blocks at 0.9
regrouped), the 2048 GEMM (0.7), the 18 convs at batch 8 and the 19 (the
1 x 1 b2.ds too) at batch 128 (0.7, summed); K2 at batch 128, 224 x 224, over ResNet-18's 19 trunk
convs (ReLU on c1, the residual join on c2), summed by stage and in all,
and over ResNet-50's 36 (its c1, c2 and downsample convs; the c3 run K7);
K5 at the LM's prefill (T 640, dh 64, causal) at BH 8 and 64, one launch;
K7 at the 16 c3 of the seed-0 ResNet-50 at batch 128 (the checkout's
model: its c3 weights, biases, factors and scales, joined by the proven
reciprocal where the checkout's model finds one; seeded int8 inputs and
residuals), summed by stage and in all, with ``torch._int_mm``'s time on
the same products;
K8 at the conv sweep's four cases (``bench --conv``'s data: batch 64,
128 x 128 tap blocks zeroed at 0.7, seed 1), each case and their sum, with
the dense K2 on the same weights timed beside each, and at l3.c1 and l4.ds
with (16, 14) blocks (``chip_smoke.py`` phase 22's data, seed 4);
LM: the checkout's serving LM (``chip_smoke.py``'s phase 11 model: d_model
512, 8 heads, d_ff 1024, 4 layers, vocab 256, 0.8 block sparsity, seed 0,
calibrated on 16 seeded tokens), at phase 13's request: the prefill of a
640-token prompt through K5 and the 255 decode steps after it, at batch 1
and 8 (host clock to a sync, medians of 5), the device time under
torch.profiler of one batch-1 prefill and of 32 decode steps after it, and
two row checks, each the largest |logit difference| over 64 seeded tokens
fed to clones of one prefilled cache: eight identical rows against a lone
decode (``max_abs_err``), and, where the checkout has ``verify_step``,
16-token verify passes against the lone decode steps; and, where it has
``runtime/paged.py``, ``score()`` of 200 prompt tokens against the
teacher-forced forward's log-probs (``chip_smoke.py`` phase 29's check);
K4C: K4's conv route (``bsr_conv2d_int8``, one launch a conv, where the
checkout has it) against the three stages it replaced (``im2col_nchw``,
K4's ``bsr_matmul_wt``, ``add_residual`` and the channels-last copy, as
``Int8Conv`` ran them) at each of ResNet-18's 19 trunk convs at batch 128,
224 x 224, 14 x 14 blocks at 0.7 (seed 3; the residual joined at each
c2), layer by layer and summed, the route's plain version once a layer
beside them, with each layer's bound (its input and
output bytes, stored blocks and their indices once, or its operations
over the stored blocks' elements; ``cardbench``'s roofline count) in a
line of its own; ``--cases K4`` runs it too;
R18: the checkout's whole ResNet-18 forward at batch 128 through
``InferenceEngine.benchmark`` (seed-0 weights, median of ``--iters``),
dense and pruned 0.7 in 128 x 128 blocks (K4's Hopper path); R50: its
dense ResNet-50 forward the same way.
The trunk's conv shapes come from this script's own checkout
(``models/resnet.py::trunk_convs``), so every checkout times the same
convs.

    python resnet_accel_tpu_torch/kernel_ab.py --repo C --splits 1,2,4,8

times K3 and K4 instead at each cluster split given, forced in place of
the wrappers' choice (and at their choice), with the host time of one
call issued while the card spins, the card's event floor (a one-element
add), the fixed cost of a launch (K4 over weights that store no block)
the sparse ResNet-18's b0.c1 and b2.c1 at batch 128 with int32 and
with served int8 output, and K4's four 14 x 14 cases (``--splits 1``:
the small-block path with no split).

    python resnet_accel_tpu_torch/kernel_ab.py --repo C --k2-tiles 64,128

times K2 instead at each trunk conv of ResNet-18 and ResNet-50 (batch
128) with each N tile given, forced in place of ``conv_tile_n``'s choice;
``--k5-chunks 1,2,4`` times K5 at the prefill (BH 8 and 64) with each
chunk size (key tiles a CTA) forced in place of ``flash_plan``'s.

    python resnet_accel_tpu_torch/kernel_ab.py --repo P --repo C --sass

compiles the sources K2, K3, K4, K7 and K8 share the main loop in
(``conv_int8.cu``, ``matmul_int8.cu``, ``bsr_matmul.cu``,
``expand_add.cu``, ``sparse_conv.cu``) to cubins in each checkout (``nvcc -cubin``, the
package's flags, ``-Xptxas -v``), disassembles them (``cuobjdump
-sass``) and prints, for each kernel of the first checkout, whether the
second holds the same instructions (addresses and the kernels' names left
out of the comparison: a template argument added with a default renames
a kernel but changes none of its code), with instruction counts and the
registers and spills ptxas reports.

    python resnet_accel_tpu_torch/kernel_ab.py --repo C --ablate

times K1 and K10 at their batch-128 cases, K2 at ResNet-18's 19 convs, K4's
small-block path at its four 14 x 14 cases and K5 at the prefill on the
checkout and on copies of its package with one part knocked out
(``ABLATIONS``; the copies are built under the checkout's
``resnet_accel_tpu_torch/_build/``): what the part costs, not a result.
With ``--cases K1`` only K1, K10 and K1's ablations run (``--cases
K1,K10``: K10's too; ``--cases K4``: K4's; ``--cases K7``: K7 at the 16
c3 with the join divided, the join knocked out, the residual read from
L2 (one place for every tile) instead of device memory, each residual
loaded as its tile's epilogue starts instead of one epilogue ahead, and
no epilogue arithmetic; ``--cases K8``: K8's Hopper route at the sweep's
four cases with no stores, with no block walked, and returning at once,
each case also timed as two calls back to back, ``pair_ms``).
The stem's ablations edit the
tile K1 and K10 share (``csrc/stem_mma_tile.cuh``), so each reaches both
but ``k1_no_loads`` (fp32 loads), ``k10_no_loads`` (int8 loads) and
``k10_no_requant`` (unpooled K10's requant).
``--cases LM`` runs the LM case on the checkout and on copies whose
decode path sums a part in float32 instead of float64: the LayerNorms
(``lm_ln32``), the attention (``lm_attn32``), the readout
(``lm_readout32``) and all three (``lm_f32``), and a copy whose
teacher-forced forward is float32 (``lm_fwd32``): what each costs a
decode step, and whether rows and ``score()`` still hold without it.
Needs a card; exits non-zero without one.
"""

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

#: The main loop's kConv kernels (K2, K8) store nothing.
_CONV_NO_EPILOGUE = [
    ("sm90_gemm_s8.cuh",
     "const bool via_tma =\n"
     "          C::kTmaOut && p.tma_out && p.split == 1 && wk.nsteps > 0;",
     "const bool via_tma = false;"),
    ("sm90_gemm_s8.cuh",
     "        store_fragment<BN, kConv>(p, acc, wk, r0, lq);",
     "        if (!kConv) store_fragment<BN, kConv>(p, acc, wk, r0, lq);"),
]

#: The decode path's float64 reductions, each back in float32, and the
#: LM's teacher-forced forward in float32 (``lm_*``).
_LM_LN32 = ("models/transformer.py",
            "        if not rows:\n            mu = v.mean(",
            "        if True:\n            mu = v.mean(")
_LM_ATTN32 = ("models/transformer.py",
              "        if not rows:\n            logits = torch.matmul(",
              "        if True:\n            logits = torch.matmul(")
_LM_READOUT32 = ("models/lm.py",
                 "        return torch.matmul(h.to(torch.float64),\n"
                 "                            self.embed64.T).to(torch.float32)",
                 "        return torch.matmul(h, self.embed.T)")
_LM_FWD32 = ("models/lm.py",
             "flash=flash, plain=plain, rows=True)\n"
             "        return self._logits(x, rows=True)",
             "flash=flash, plain=plain)\n        return self._logits(x)")

#: Parts of a kernel knocked out for ``--ablate``: (source under csrc/, or
#: a path under the package, text, replacement) edits, each of which must
#: apply once.
ABLATIONS = {
    # The stem tile's GEMM steps become an XOR of their operands: the A
    # loads and the B registers stay, the tensor-core work goes
    "k1_no_mma": [
        ("stem_mma_tile.cuh",
         "for (int j = 0; j < 4; ++j) mma_s8(acc[j], a, b[j][s][0], "
         "b[j][s][1]);",
         "for (int j = 0; j < 4; ++j) acc[j][0] ^= a[0] ^ a[1] ^ a[2] ^ "
         "a[3] ^ b[j][s][0] ^ b[j][s][1];"),
    ],
    # The pool reads the centre column of each conv row only: a third of
    # its shared-memory reads
    "k1_pool_one_col": [
        ("stem_mma_tile.cuh", "for (int dc = 0; dc < 3; ++dc)",
         "for (int dc = 1; dc < 2; ++dc)"),
    ],
    # K1 stages a pattern in place of the input's loads (quantize stays)
    "k1_no_loads": [
        ("stem_mma_tile.cuh",
         "? __ldg(xp + (d / 2) * W + d % 2)\n                      : 0.f;",
         "? static_cast<float>((e + d) & 15)\n                      : 0.f;"),
    ],
    # K10 stages a pattern in place of the input's loads, 16-bit and byte
    "k10_no_loads": [
        ("stem_mma_tile.cuh",
         "? __ldg(reinterpret_cast<const uint16_t*>(xp + d * W))",
         "? static_cast<uint32_t>((e + d) & 0x0f0f)"),
        ("stem_mma_tile.cuh",
         "? __ldg(xp + (d / 2) * W + d % 2)\n                      : 0;",
         "? (e + d) & 15\n                      : 0;"),
    ],
    # Unpooled K10's epilogue with a shift in place of each output's
    # requant (the int8 tile and its stores stay)
    "k10_no_requant": [
        ("stem_mma_tile.cuh",
         "const int q0 = requant_i8(max(acc[j][2 * h] + bs[o], 0), fs[o]);\n"
         "            const int q1 =\n"
         "                requant_i8(max(acc[j][2 * h + 1] + bs[o + 1], 0), "
         "fs[o + 1]);",
         "const int q0 = max(acc[j][2 * h] + bs[o], 0) >> 8;\n"
         "            const int q1 = max(acc[j][2 * h + 1] + bs[o + 1], 0) >> 8;"),
    ],
    # K2 sums and loads as it does, but stores nothing: its main loop alone
    "k2_no_epilogue": _CONV_NO_EPILOGUE,
    # K8's Hopper route sums and loads as it does, but stores nothing (the
    # same edits as K2's: both are kConv)
    "k8_no_epilogue": _CONV_NO_EPILOGUE,
    # K8's Hopper route walks no block: the launch, the barriers' set-up
    # and the bias-only epilogue of every tile
    "k8_no_walk": [
        ("sm90_gemm_s8.cuh",
         "wk.nsteps = wk.ncols > 0 ? wk.nsteps * wk.sub : 0;",
         "wk.nsteps = 0;"),
    ],
    # K8's Hopper route returns at once: the launch of its grid alone
    "k8_empty": [
        ("sm90_gemm_s8.cuh",
         "  using C = Cfg<BN, kExpand>;\n  extern __shared__ uint8_t "
         "smem_raw[];",
         "  if constexpr (kBsr && kConv) return;\n"
         "  using C = Cfg<BN, kExpand>;\n  extern __shared__ uint8_t "
         "smem_raw[];"),
    ],
    # K4's small-block path with no tensor-core work: the loads, barriers
    # and stores stay
    "k4_no_mma": [
        ("bsr_matmul.cu",
         "          wgmma_n16(acc[h],\n"
         "                    smem_desc(a + b * kSmallBoxA + h * 64 * "
         "kSmallWin,\n"
         "                              kSmallWin, 3),\n"
         "                    smem_desc(w + b * 16 * kSmallWin, kSmallWin, "
         "3));",
         "          acc[h][b] += static_cast<int>(a);"),
    ],
    # K4's small-block path loads no A window: W's box and the MMA stay
    "k4_no_a": [
        ("bsr_matmul.cu",
         "mbar_expect_tx(bar, kSmallW + (c.y >= 0 ? 2 : 1) * kSmallBoxA);",
         "mbar_expect_tx(bar, kSmallW);"),
        ("bsr_matmul.cu",
         "        tma_load(a, &map_a, x0 - x0 % 16, m0, bar);",
         "        if (x0 < 0) tma_load(a, &map_a, x0 - x0 % 16, m0, bar);"),
        ("bsr_matmul.cu",
         "        if (c.y >= 0)\n"
         "          tma_load(a + kSmallBoxA, &map_a, x1 - x1 % 16, m0, bar);",
         ""),
    ],
    # K7 divides by s_out where it has the proven reciprocal
    "k7_divide": [
        ("sm90_gemm_s8.cuh",
         "const float t = kExpand == kExpandInv ? __fmul_rn(s, p.inv_out)\n"
         "                                        : __fdiv_rn(s, p.s_out);",
         "const float t = __fdiv_rn(s, p.s_out);"),
    ],
    # K7's join becomes an XOR of its operands: the requant, the residual
    # and the stores stay, the join's arithmetic goes
    "k7_no_join": [
        ("sm90_gemm_s8.cuh",
         "  const float s = __fadd_rn(__fmul_rn(z, p.s_main), "
         "__fmul_rn(r, p.s_res));",
         "  return __float_as_uint(z) ^ __float_as_uint(r);\n"
         "  const float s = 0.f;"),
    ],
    # K7 loads every tile's residual from one place, which stays in L2:
    # the residual's device-memory reads go, its boxes and barriers stay
    "k7_residual_l2": [
        ("sm90_gemm_s8.cuh",
         "tma_load(res_tile<C>(full, b), map, wk.n0, wk.m0,",
         "tma_load(res_tile<C>(full, b), map, 0, 0,"),
    ],
    # K7 loads each tile's residual as its own epilogue starts, not one
    # epilogue ahead
    "k7_residual_late": [
        ("sm90_gemm_s8.cuh",
         "          if (tile + tile_step < tiles)\n"
         "            load_res<BN, C>(p, &map_res, tile + tile_step, full, "
         "buf ^ 1);",
         "          load_res<BN, C>(p, &map_res, tile, full, buf);"),
        ("sm90_gemm_s8.cuh",
         "      if (tid == 0 && tile0 < tiles)\n"
         "        load_res<BN, C>(p, &map_res, tile0, full, 0);",
         "      ;"),
    ],
    # K7 without its epilogue's arithmetic: the main loop, the residual's
    # loads into the buffer and its store back, as they are
    "k7_no_epilogue": [
        ("sm90_gemm_s8.cuh",
         "        join_tile<BN, kExpand>(p, acc, wk, r0, lq,\n"
         "                               smem + (res_tile<C>(full, buf) - "
         "base));",
         "        ;"),
    ],
    # K5 with one TF32 pass (hi.hi) in place of three
    "k5_one_pass": [
        ("flash_attention.cu",
         "  mma_tf32(d, alo, bh0, bh1);\n  mma_tf32(d, ahi, bl0, bl1);\n",
         ""),
    ],
    # K5 with the three passes but no operand splits (hi = lo = x)
    "k5_no_split": [
        ("flash_attention.cu",
         '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));\n'
         "  const float r = __fsub_rn(x, __uint_as_float(hi));\n"
         '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(r));',
         "  hi = lo = __float_as_uint(x);"),
    ],
    "lm_ln32": [_LM_LN32],
    "lm_attn32": [_LM_ATTN32],
    "lm_readout32": [_LM_READOUT32],
    "lm_f32": [_LM_LN32, _LM_ATTN32, _LM_READOUT32],
    "lm_fwd32": [_LM_FWD32],
}

#: chip_smoke.py's serving LM (phase 11) and phase 13's request.
LM_CFG = dict(vocab=256, d_model=512, n_heads=8, d_ff=1024, n_layers=4,
              max_len=1024, sparsity=0.8, block=8)
LM_PROMPT, LM_NEW, LM_BATCH = 640, 256, 8

#: The pruned ResNet-18's 18 sparse convs at 224 x 224 after im2col, per
#: image: (output pixels, K = C * k * k, N = output channels).
RESNET18_SPARSE_CONVS = (
    [(56 * 56, 576, 64)] * 4
    + [(28 * 28, 576, 128)] + [(28 * 28, 1152, 128)] * 3
    + [(14 * 14, 1152, 256)] + [(14 * 14, 2304, 256)] * 3
    + [(14 * 14, 128, 256)]
    + [(7 * 7, 2304, 512)] + [(7 * 7, 4608, 512)] * 3
    + [(7 * 7, 256, 512)])
#: At 14 x 14 all 19 trunk convs are sparse: b2.ds (1 x 1, 64 -> 128) too.
RESNET18_SPARSE_CONVS_14 = (RESNET18_SPARSE_CONVS[:8] + [(28 * 28, 64, 128)]
                            + RESNET18_SPARSE_CONVS[8:])

SPIN_CYCLES = 5_000_000


def _time_ms(torch, fn, iters):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _host_ms(torch, fn):
    """Host time of one ``fn()`` issued while the card spins: near the
    spin's own length if ``fn`` waits for the card."""
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    t0 = time.perf_counter()
    fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3


def _run(repo: str, iters: int, trunks, cases=()) -> None:
    """The cases against the package under ``repo``, in this process;
    ``trunks``: ResNet-18's and ResNet-50's trunk convs as
    ``trunk_convs`` gives them; ``cases``: name prefixes to keep (all if
    empty)."""
    sys.path.insert(0, os.path.abspath(repo))
    import numpy as np
    import torch

    from resnet_accel_tpu_torch import _kernels, ops

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA card")
    dev = torch.device("cuda", torch.cuda.current_device())
    _kernels.build()
    rng = np.random.default_rng(0)
    library = {}

    def emit(case, ms, plan=None):
        print(json.dumps({"repo": repo, "case": case, "ms": ms,
                          "plan": plan}), flush=True)

    def i8(shape):
        return torch.randint(-128, 128, shape, dtype=torch.int8, device=dev)

    def plan_of(fn, *args):
        p = getattr(ops, fn, None)     # a checkout before the plans: None
        return None if p is None else str(p(*args))

    def want(kernel):
        return not cases or any(kernel.startswith(c) for c in cases)

    # ---- K1, K10 ----
    if want("K1"):
        emit(K1_CASE, _time_ms(torch, _k1_call(torch, ops, dev), iters),
             plan_of("stem_plan", 128, 224, 224, _kernels.sm_count(dev)))
    for pool in (True, False) if want("K10") else ():
        fn, plan = _k10_call(torch, ops, dev, pool)
        emit(K10_CASES[pool], _time_ms(torch, fn, iters), plan)

    # ---- K3 ----
    for case, M, K, N, requant in (("fc512", 128, 512, 1000, False),
                                   ("fc2048", 128, 2048, 1000, False),
                                   ("mnist_fc1", 128, 9216, 128, True),
                                   ("mnist_fc2", 128, 128, 10, False)
                                   ) if want("K3") else ():
        a, w = i8((M, K)), i8((N, K))
        bias = torch.randint(-3000, 3000, (N,), dtype=torch.int32,
                             device=dev)
        kw = dict(bias=bias)
        if requant:
            kw.update(factors=torch.full((N,), 1e-4, device=dev), relu=True)
        # the served layout: the .t() view where the kernel takes it
        b = w.t() if hasattr(ops, "matmul_plan") else w.t().contiguous()
        emit(f"K3 {case}", _time_ms(torch, lambda: ops.matmul_int8(
            a, b, **kw), iters), plan_of("matmul_plan", a, w))
        if N % 8 == 0:
            wt = w.t()
            library[f"K3 {case}"] = _time_ms(
                torch, lambda: torch._int_mm(a, wt) + bias, iters)

    # ---- K4 ----
    for case, calls in _k4_cases(torch, ops, rng, dev) if want("K4") else ():
        total = lib_total = 0.0
        plans = set()
        for A, pk, W in calls:
            total += _time_ms(torch, lambda: ops.bsr_matmul_wt(A, pk), iters)
            plans.add(plan_of("bsr_plan", A, pk))
            wt = torch.from_numpy(W).to(dev).t()
            lib_total += _time_ms(torch, lambda: torch._int_mm(A, wt), iters)
        emit(case, total, " ".join(sorted(str(p) for p in plans)))
        library[case] = lib_total
        del calls

    # ---- K4's conv route against the three stages ----
    if want("K4C"):
        totals = {}
        for name, calls in _k4c_calls(torch, ops, dev, trunks[18]):
            for what, fn in calls.items():
                # the plain version (float64 products) once: it is slow
                ms = (fn() if what == "bound" else
                      None if fn is None else
                      _time_ms(torch, fn, 1 if what == "plain" else iters))
                if ms is not None:
                    emit(f"K4C {what} {name} 14 batch 128", ms)
                    totals[what] = totals.get(what, 0.0) + ms
        for what, ms in totals.items():
            emit(f"K4C {what} resnet18 19 convs 14 batch 128", ms)

    # ---- K2 ----
    for depth, convs in trunks.items() if want("K2") else ():
        stages, total = {}, 0.0
        for name, stage, *shape in convs:
            if name.endswith(".c3"):
                continue            # K7's in the served forward
            fn = _k2_call(torch, ops, rng, dev, depth, name, *shape)
            ms = _time_ms(torch, fn, iters)
            stages[stage] = stages.get(stage, 0.0) + ms
            total += ms
            del fn
        n = sum(not c[0].endswith(".c3") for c in convs)
        for stage, ms in sorted(stages.items()):
            emit(f"K2 resnet{depth} stage {stage} batch 128", ms)
        emit(f"K2 resnet{depth} {n} convs batch 128", total)

    # ---- K7 ----
    if want("K7"):
        stages, lib_stages = {}, {}
        for stage, fn, lib in _k7_calls(torch, ops, dev):
            stages[stage] = stages.get(stage, 0.0) + _time_ms(torch, fn,
                                                              iters)
            lib_stages[stage] = lib_stages.get(stage, 0.0) + _time_ms(
                torch, lib, iters)
        for stage in sorted(stages):
            emit(f"K7 resnet50 stage {stage} batch 128", stages[stage])
            library[f"K7 resnet50 stage {stage} batch 128"] = \
                lib_stages[stage]
        emit("K7 resnet50 16 c3 batch 128", sum(stages.values()),
             plan_of("expand_plan", *_k7_plan_args(torch, dev)))
        library["K7 resnet50 16 c3 batch 128"] = sum(lib_stages.values())

    # ---- K8 ----
    if want("K8"):
        total = 0.0
        for case, fn, dense, plan, sweep in _k8_calls(torch, ops, dev):
            ms = _time_ms(torch, fn, iters)
            emit(case, ms, plan)
            if sweep:
                total += ms
                emit(f"K8 dense K2 {case[3:]}", _time_ms(torch, dense, iters))
        emit("K8 sweep 4 cases 128x128 batch 64", total)

    # ---- K5 ----
    sdpa = torch.nn.functional.scaled_dot_product_attention
    torch.backends.cuda.matmul.allow_tf32 = False
    for BH in (8, 64) if want("K5") else ():
        q, k, v = (torch.randn((BH, 640, 64), device=dev) for _ in range(3))
        emit(f"K5 BH {BH} T 640 causal", _time_ms(
            torch, lambda: ops.flash_attention(q, k, v, causal=True), iters))
        library[f"K5 BH {BH} T 640 causal"] = _time_ms(
            torch, lambda: sdpa(q, k, v, is_causal=True), iters)
    for case, key, value in _lm_cases(torch, dev) if want("LM") else ():
        print(json.dumps({"repo": repo, "case": case, key: value}),
              flush=True)
    # ---- whole forwards ----
    if want("R18"):
        _r18_forwards(repo, iters, emit)
    if want("R50"):
        _r50_forward(iters, emit)
    print(json.dumps({"repo": repo, "library_ms": library}), flush=True)


def _lm_cases(torch, dev):
    """The LM case (see the module docstring): yields (case, "ms" or
    "max_abs_err", value)."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from resnet_accel_tpu_torch.models.lm import TransformerLMInt8
    vocab = LM_CFG["vocab"]
    lm = TransformerLMInt8.from_random(**LM_CFG, seed=0)
    scales = lm.calibrate(np.random.default_rng(0).integers(
        0, vocab, 16).astype(np.int32))
    prng = np.random.default_rng(2)
    prompt = prng.integers(0, vocab, LM_PROMPT).astype(np.int32)
    prompts = prng.integers(0, vocab, (LM_BATCH, LM_PROMPT)).astype(np.int32)
    fed = torch.as_tensor(prng.integers(0, vocab, 64), device=dev)
    lmod = lm.module(dev)
    sc = lmod.prepare_scales(scales)

    def busy_ms(fn):
        """The card's own time in one ``fn()`` under torch.profiler, as
        ``chip_smoke.py``'s phase 13 sums it."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type != DeviceType.CPU) / 1e3

    def clone(caches, lead=()):
        return [dict(c, **{n: c[n].expand(*lead, *c[n].shape).clone()
                           for n in ("k", "v")}) for c in caches]

    with torch.inference_mode():
        for toks, B in ((prompt, 1), (prompts, LM_BATCH)):
            pre, dec = [], []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                last, caches = lmod.prefill(toks, sc, flash=True)
                tok = last.argmax(dim=-1)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                for _ in range(LM_NEW - 1):
                    logits, caches = lmod.decode_step(caches, tok, sc)
                    tok = logits.argmax(dim=-1)
                torch.cuda.synchronize()
                pre.append((t1 - t0) * 1e3)
                dec.append((time.perf_counter() - t1) * 1e3 / (LM_NEW - 1))
            yield f"LM prefill {LM_PROMPT} batch {B}", "ms", \
                statistics.median(pre)
            yield f"LM decode step batch {B}", "ms", statistics.median(dec)

        last, caches = lmod.prefill(prompt, sc, flash=True)
        busy_ms(lambda: lmod.prefill(prompt, sc, flash=True))   # warm-up
        yield f"LM prefill {LM_PROMPT} batch 1 device busy", "ms", busy_ms(
            lambda: lmod.prefill(prompt, sc, flash=True))
        c1, c8, cv = clone(caches), clone(caches, (LM_BATCH,)), \
            clone(caches)
        tok = last.argmax(dim=-1)

        def decode32():
            nonlocal caches, tok
            for _ in range(32):
                logits, caches = lmod.decode_step(caches, tok, sc)
                tok = logits.argmax(dim=-1)
        yield "LM 32 decode steps batch 1 device busy", "ms", busy_ms(
            decode32)

        lone, err8 = [], 0.0
        for t in fed:
            l1, c1 = lmod.decode_step(c1, t, sc)
            l8, c8 = lmod.decode_step(c8, t.expand(LM_BATCH), sc)
            err8 = max(err8, float((l8 - l1).abs().max()))
            lone.append(l1)
        yield f"LM rows: {LM_BATCH} rows against a lone decode, 64 steps", \
            "max_abs_err", err8
        if hasattr(lmod, "verify_step"):
            errv = 0.0
            for w in range(0, len(fed), 16):
                lv, cv = lmod.verify_step(cv, fed[w:w + 16], sc)
                errv = max(errv, float(
                    (lv - torch.stack(lone[w:w + 16])).abs().max()))
            yield "LM rows: verify 16 against decode steps, 64 positions", \
                "max_abs_err", errv
        try:
            from resnet_accel_tpu_torch.runtime.paged import PagedKVBatcher
        except ImportError:                 # a checkout before the batchers
            return
        seq = prompt[:200]
        lp = PagedKVBatcher(lm, scales, slots=2, page=16, pool_pages=32,
                            device=dev).score([seq])[0]
        want = torch.log_softmax(lmod.forward(seq, scales), -1)[
            torch.arange(len(seq) - 1), torch.as_tensor(
                seq[1:], device=dev).long()].cpu().numpy()
        yield "LM score() against the teacher-forced forward, 200 tokens", \
            "max_abs_err", float(np.abs(lp - want).max())


def _r18_forwards(repo, iters, emit):
    """The checkout's ResNet-18 forward at batch 128, seed 0: dense, and
    pruned 0.7 in 128 x 128 blocks with BSR attached."""
    import numpy as np

    from resnet_accel_tpu_torch.models.resnet18 import (
        attach_bsr, init_resnet18_fp32, prune_params_blockwise,
        quantize_resnet18)
    from resnet_accel_tpu_torch.runtime.engine import InferenceEngine
    rng = np.random.default_rng(0)
    calib = rng.normal(0, 1, (2, 3, 224, 224)).astype(np.float32)
    x = rng.normal(0, 1, (128, 3, 224, 224)).astype(np.float32)
    params = init_resnet18_fp32(seed=0, num_classes=1000)
    sparse = attach_bsr(quantize_resnet18(
        prune_params_blockwise(params, sparsity=0.7, block=128), calib,
        1000), block=128, min_sparsity=0.25)
    for name, model in (("dense", quantize_resnet18(params, calib, 1000)),
                        ("sparse 128x128", sparse)):
        bench = InferenceEngine(model, device="cuda").benchmark(x, iters)
        emit(f"R18 {name} forward batch 128", bench.latency_s * 1e3)


def _r50_forward(iters, emit):
    """The checkout's dense ResNet-50 forward at batch 128, seed 0."""
    import numpy as np

    from resnet_accel_tpu_torch.runtime.engine import InferenceEngine
    x = np.random.default_rng(0).normal(0, 1, (128, 3, 224, 224)).astype(
        np.float32)
    bench = InferenceEngine(_resnet50(), device="cuda").benchmark(x, iters)
    emit("R50 dense forward batch 128", bench.latency_s * 1e3)


def _resnet50():
    """The checkout's seed-0 ResNet-50 (1000 classes), calibrated on two
    seeded 224 x 224 images on the CPU, as ``chip_smoke.py`` makes it."""
    import numpy as np

    from resnet_accel_tpu_torch.models.resnet import (init_resnet_fp32,
                                                      quantize_resnet)
    calib = np.random.default_rng(0).normal(0, 1, (2, 3, 224, 224)).astype(
        np.float32)
    return quantize_resnet(init_resnet_fp32(50, seed=0, num_classes=1000),
                           calib, 50, 1000)


def _k7_calls(torch, ops, dev):
    """(stage, one K7 call, one ``torch._int_mm`` on its product) at each
    of the 16 c3 of the checkout's seed-0 ResNet-50 at batch 128: its c3
    weight, bias, factors and scales, and the proven reciprocal where the
    checkout's module finds one; seeded int8 inputs and residuals."""
    from resnet_accel_tpu_torch.models.resnet import trunk_convs
    from resnet_accel_tpu_torch.models.resnet18 import ResNet18Int8Module
    mod = ResNet18Int8Module(_resnet50(), dev)
    invs = getattr(mod, "inv_out", [None] * len(mod.blocks))  # older
    cl = torch.channels_last
    gen = torch.Generator(device=dev).manual_seed(0)
    calls = []
    for c in trunk_convs(50):
        if not c.name.endswith(".c3"):
            continue
        i = int(c.name[1:].split(".")[0])
        c3 = mod.blocks[i]["c3"]
        w = c3.weight.reshape(c3.weight.shape[0], -1)

        def i8(shape):
            return torch.randint(-128, 128, shape, dtype=torch.int8,
                                 device=dev, generator=gen).contiguous(
                                     memory_format=cl)
        x, r = i8((128, c.C, c.H, c.H)), i8((128, c.O, c.H, c.H))
        kw = {} if invs[i] is None else {"inv_out": invs[i]}
        a2d, wt = x.permute(0, 2, 3, 1).reshape(-1, c.C), w.t()
        calls.append((c.stage, lambda x=x, w=w, c3=c3, r=r, rs=mod.res_scales[
            i], kw=kw: ops.expand_add_int8(x, w, c3.bias, c3.factors, r, *rs,
                                           **kw),
                      lambda a2d=a2d, wt=wt: torch._int_mm(a2d, wt)))
    return calls


def _k7_plan_args(torch, dev):
    """``expand_plan``'s arguments at ResNet-50's stage-1 c3, batch 128."""
    cl = torch.channels_last
    return (torch.empty((128, 64, 56, 56), dtype=torch.int8, device=dev,
                        memory_format=cl),
            torch.empty((256, 64), dtype=torch.int8, device=dev),
            torch.empty((256,), dtype=torch.int32, device=dev),
            torch.empty((256,), device=dev),
            torch.empty((128, 256, 56, 56), dtype=torch.int8, device=dev,
                        memory_format=cl))


K1_CASE = "K1 stem batch 128 224x224"
K10_CASES = {True: "K10 stem pooled batch 128 224x224",
             False: "K10 stem unpooled batch 128 224x224"}


def _stem_inputs(torch, dev):
    """ResNet-18's stem at batch 128, 224 x 224: seeded normal images, int8
    OIHW weights, bias, factors and the input scale."""
    import numpy as np
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(0, 1, (128, 3, 224, 224)).astype(
        np.float32)).to(dev)
    w = torch.from_numpy(rng.integers(-128, 128, (64, 3, 7, 7)).astype(
        np.int8)).to(dev)
    bias = torch.randint(-5000, 5000, (64,), dtype=torch.int32, device=dev)
    f = torch.full((64,), 4e-3, device=dev)
    return x, w, bias, f, float(x.abs().max()) / 127.0


def _k1_call(torch, ops, dev):
    """One K1 call at the stem, on the weight packed where the checkout
    packs it."""
    x, w, bias, f, scale = _stem_inputs(torch, dev)
    pack = getattr(ops, "pack_stem_weight", None)       # older checkouts
    wk = w if pack is None else pack(w)
    return lambda: ops.stem_conv_pool(x, wk, bias, f, scale)


def _k10_call(torch, ops, dev, pool):
    """One K10 call at the stem on K1's images quantized, and its plan: the
    packed weight and the plan where the checkout's K10 runs the tensor-core
    tile, else the OIHW weight and no plan."""
    x, w, bias, f, scale = _stem_inputs(torch, dev)
    q = ops.quantize_input(x, scale)
    plan = None
    if hasattr(ops.stem_fused, "STEM_CONV_TILE"):
        w = ops.pack_stem_weight(w)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = str(ops.stem_plan(128, 224, 224, sms, pool))
    return (lambda: ops.stem_conv_pool_int8(q, w, bias, f, pool=pool)), plan


def _k2_call(torch, ops, rng, dev, depth, name, C, O, H, k, s):
    """One K2 call at a trunk conv of batch 128, as the forward makes it:
    ReLU on c1, the residual join on ResNet-18's c2; seeded int8 data."""
    import numpy as np
    cl = torch.channels_last

    def i8(shape):
        return torch.randint(-128, 128, shape, dtype=torch.int8, device=dev)
    x = i8((128, C, H, H)).contiguous(memory_format=cl)
    w = ops.pack_weight(rng.integers(-128, 128, (O, C * k * k)).astype(
        np.int8), C, k, dev)
    bias = torch.randint(-3000, 3000, (O,), dtype=torch.int32, device=dev)
    f = torch.full((O,), 0.011 / (C * k * k) ** 0.5, device=dev)
    kw = dict(stride=s, padding=k // 2, relu=name.endswith(".c1"))
    if depth == 18 and name.endswith(".c2"):
        Ho = (H + 2 * (k // 2) - k) // s + 1
        kw.update(residual=i8((128, O, Ho, Ho)).contiguous(memory_format=cl),
                  res_scales=(0.0213, 0.0172, 0.0311))
    return lambda: ops.conv2d_int8(x, w, bias, f, **kw)


def _k8_calls(torch, ops, dev):
    """K8's cases: (name, K8 call, dense K2 call on the same weights, K8's
    plan, whether the case is one of the sweep's four at 128 x 128).  The
    sweep's data as ``bench --conv`` draws it (seed 1), then l3.c1 and
    l4.ds at (16, 14) as ``chip_smoke.py`` phase 22 draws them (seed 4);
    factors 0.001 with ReLU."""
    import numpy as np

    from resnet_accel_tpu_torch.cli import CONV_CASES
    from resnet_accel_tpu_torch.sparse import (device_pack, pack_conv_bsr,
                                               tap_sparse_weight)
    cl = torch.channels_last
    plan_fn = getattr(ops, "sparse_conv_plan", None)   # older checkouts
    for seed, blocks in ((1, (128, None)), (4, (14, 16))):
        rng = np.random.default_rng(seed)
        for name, C, O, H, k, s, p in CONV_CASES:
            if blocks[0] == 14 and name.split()[0] not in ("l3.c1", "l4.ds"):
                continue
            x = torch.from_numpy(rng.integers(
                -128, 128, (64, C, H, H)).astype(np.int8)).to(dev).contiguous(
                memory_format=cl)
            w = tap_sparse_weight(rng, O, C, k, 0.7, *blocks)
            f = torch.full((O,), 0.001, dtype=torch.float32, device=dev)
            zero = torch.zeros(O, dtype=torch.int32, device=dev)
            wd = ops.pack_weight(w.reshape(O, -1), C, k, dev)
            pk = device_pack(pack_conv_bsr(w, padding=p, block_o=blocks[0],
                                           block_c=blocks[1]), dev)
            tag = "128x128" if blocks[0] == 128 else "16x14"
            yield (f"K8 {name} {tag} {pk.nnz_source}/{pk.total_source} "
                   f"batch 64",
                   lambda x=x, pk=pk, f=f, s=s: ops.sparse_conv2d_int8(
                       x, pk, factors=f, relu=True, stride=s),
                   lambda x=x, wd=wd, zero=zero, f=f, s=s, p=p:
                   ops.conv2d_int8(x, wd, zero, f, stride=s, padding=p,
                                   relu=True),
                   None if plan_fn is None else str(plan_fn(x, pk)),
                   blocks[0] == 128)


def _k2_tile_sweep(repo: str, iters: int, tiles, trunks) -> None:
    """K2 at every trunk conv with each N tile of ``tiles`` forced."""
    sys.path.insert(0, os.path.abspath(repo))
    import numpy as np
    import torch

    from resnet_accel_tpu_torch import _kernels, ops

    conv_mod = sys.modules["resnet_accel_tpu_torch.ops.conv"]
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA card")
    dev = torch.device("cuda", torch.cuda.current_device())
    _kernels.build()
    rng = np.random.default_rng(0)
    chosen = conv_mod.conv_tile_n
    for depth, convs in trunks.items():
        for name, stage, *shape in convs:
            fn = _k2_call(torch, ops, rng, dev, depth, name, *shape)
            C, O, _, k, _ = shape
            row = {"repo": repo, "case": f"K2 resnet{depth} {name}",
                   "shape": shape, "chosen": chosen(O, k * k * C)}
            for bn in tiles:
                conv_mod.conv_tile_n = lambda *_, bn=bn: bn
                row[str(bn)] = _time_ms(torch, fn, iters)
            conv_mod.conv_tile_n = chosen
            print(json.dumps(row), flush=True)


#: The sources whose kernels run sm90_gemm_s8.cuh's main loop.
SASS_SOURCES = ("conv_int8.cu", "matmul_int8.cu", "bsr_matmul.cu",
                "expand_add.cu", "sparse_conv.cu")


def _sass(repo: str, flags) -> dict:
    """{kernel: (instructions, ptxas's registers and spills)} of the
    sources in SASS_SOURCES under ``repo``, compiled to cubins under its
    build directory.  Kernel names lose their anonymous namespace's tag
    (a hash of the file) and K7's join argument where it is 0 (the
    default every kernel but K7's takes); instructions lose their
    addresses and encodings."""
    import re
    csrc = os.path.join(os.path.abspath(repo), "resnet_accel_tpu_torch",
                        "csrc")
    out_dir = os.path.join(os.path.dirname(csrc), "_build", "sass")
    os.makedirs(out_dir, exist_ok=True)
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    kernels = {}

    def norm(name):
        name = re.sub(r"\d+_GLOBAL__N__\w+?_[0-9a-f]{8}", "ANON", name)
        # K7's residual map, a parameter after Params, renames the rest
        return re.sub(r"ParamsES2_$", "ParamsE",
                      name.replace("ELi0EEEv", "EEEv"))
    for src in SASS_SOURCES:
        cubin = os.path.join(out_dir, src + ".cubin")
        proc = subprocess.run(
            [os.path.join(cuda, "bin", "nvcc"), *flags, "-Xptxas=-v",
             "-cubin", "-o", cubin, os.path.join(csrc, src)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"kernel_ab: nvcc -cubin {src}: {proc.stderr}")
        ptxas, fn = {}, None
        for line in proc.stderr.splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                fn = norm(m.group(1))
            elif fn and ("spill" in line or "Used" in line):
                ptxas.setdefault(fn, []).append(line.split(":", 1)[-1].strip())
        dump = subprocess.run([os.path.join(cuda, "bin", "cuobjdump"),
                               "-sass", cubin], capture_output=True,
                              text=True, check=True).stdout
        fn = None
        for line in dump.splitlines():
            m = re.match(r"\s*Function : (\S+)", line)
            if m:
                fn = norm(m.group(1))
                kernels[fn] = ([], ptxas.get(fn, []))
                continue
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?);", line)
            if fn and m:
                kernels[fn][0].append(m.group(1).strip())
    return kernels


def _sass_compare(repos) -> None:
    """Each kernel of the first checkout against the second: the same
    instructions or not (:func:`_sass`)."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from resnet_accel_tpu_torch._kernels import NVCC_FLAGS
    a, b = (_sass(r, NVCC_FLAGS) for r in repos[:2])
    for name in sorted(set(a) | set(b)):
        row = {"kernel": name, "same": name in a and name in b
               and a[name][0] == b[name][0]}
        if name in a and name in b and not row["same"]:
            row["first_differences"] = [
                (i, x, y) for i, (x, y) in enumerate(zip(a[name][0],
                                                         b[name][0]))
                if x != y][:8]
        for repo, k in zip(repos, (a, b)):
            if name in k:
                row[repo] = {"instructions": len(k[name][0]),
                             "ptxas": k[name][1]}
        print(json.dumps(row), flush=True)


def _k5_inputs(torch, dev, BH):
    return tuple(torch.randn((BH, 640, 64), device=dev) for _ in range(3))


def _k5_chunk_sweep(repo: str, iters: int, chunks) -> None:
    """K5 at the prefill with each chunk size of ``chunks`` forced."""
    sys.path.insert(0, os.path.abspath(repo))
    import torch

    from resnet_accel_tpu_torch import _kernels, ops

    fa_mod = sys.modules["resnet_accel_tpu_torch.ops.flash_attention"]
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA card")
    dev = torch.device("cuda", torch.cuda.current_device())
    _kernels.build()
    limits = fa_mod.FA_MIN_CHUNK, fa_mod.FA_MAX_CHUNKS
    for BH in (8, 64):
        q, k, v = _k5_inputs(torch, dev, BH)
        row = {"repo": repo, "case": f"K5 BH {BH} T 640 causal",
               "chosen": fa_mod.flash_plan(640, 64, True)[0]}
        for ct in chunks:
            # ct = max(FA_MIN_CHUNK, ceil(nq / FA_MAX_CHUNKS)) = ct
            fa_mod.FA_MIN_CHUNK, fa_mod.FA_MAX_CHUNKS = ct, 1 << 30
            row[str(ct)] = _time_ms(torch, lambda: ops.flash_attention(
                q, k, v, causal=True), iters)
        fa_mod.FA_MIN_CHUNK, fa_mod.FA_MAX_CHUNKS = limits
        print(json.dumps(row), flush=True)


def _k4_cases(torch, ops, rng, dev, small_only=False):
    """K4's cases in order, random int8 weights with tiles zeroed at the
    case's sparsity: (case, [(A, packed weight, dense weight W [N, K]),
    ...]), a case of several calls summed.  Each case's data is made when
    it is reached (the 19 A matrices at batch 128 hold 1.6 GB).  With
    ``small_only``, only the four 14 x 14 cases: the MNIST fc1, the 2048
    GEMM, ResNet-18's 19 convs at batch 8 and 128."""
    import numpy as np

    from resnet_accel_tpu_torch.sparse import build_bsr_int8_direct

    def call(M, N, K, block, sparsity, mask_block=None):
        """A [M, K] and W [N, K] with mask_block x mask_block tiles (block
        by default) zeroed with probability ``sparsity``, as BSR at
        block."""
        mb = mask_block or block
        W = rng.integers(-128, 128, (N, K)).astype(np.int8)
        keep = rng.random((-(-N // mb), -(-K // mb))) >= sparsity
        W *= np.repeat(np.repeat(keep, mb, 0), mb, 1)[:N, :K]
        A = torch.randint(-128, 128, (M, K), dtype=torch.int8, device=dev)
        return A, ops.pack_bsr(build_bsr_int8_direct(W, block), dev), W

    for block in (14,) if small_only else (128, 14):
        yield (f"K4 mnist_fc1 {block}",
               [call(128, 128, 9216, block, 0.9, mask_block=128)])
    for n, s in () if small_only else ((2048, 0.7), (2048, 0.9),
                                       (4096, 0.7), (4096, 0.9)):
        yield f"K4 gemm{n} {s} 128", [call(512, n, n, 128, s)]
    yield "K4 gemm2048 0.7 14", [call(512, 2048, 2048, 14, 0.7)]
    for block, batch, convs in (
            (128, 128, RESNET18_SPARSE_CONVS), (14, 8, RESNET18_SPARSE_CONVS),
            (14, 128, RESNET18_SPARSE_CONVS_14)):
        if block == 14 or not small_only:
            yield (f"K4 resnet18 {len(convs)} convs {block} batch {batch}",
                   [call(batch * pix, N, K, block, 0.7)
                    for pix, K, N in convs])


def _k4c_calls(torch, ops, dev, convs):
    """ResNet-18's 19 trunk convs at batch 128 (``trunk_convs``' rows), 14
    x 14 blocks zeroed at 0.7: (name, {"route": the conv route's call and
    "plain" its plain version's, None where the checkout lacks them,
    "chain": the three stages' call, "bound": a function giving the
    layer's bound in ms}), one conv's data at a time."""
    import numpy as np

    from resnet_accel_tpu_torch.sparse import build_bsr_int8_direct
    rng = np.random.default_rng(3)
    cl = torch.channels_last
    for name, _, C, O, H, k, s in convs:
        K, pad = C * k * k, k // 2
        Ho = (H + 2 * pad - k) // s + 1
        W = rng.integers(-128, 128, (O, K)).astype(np.int8)
        keep = rng.random((-(-O // 14), -(-K // 14))) >= 0.7
        mask = np.repeat(np.repeat(keep, 14, 0), 14, 1)[:O, :K]
        W *= mask
        bsr = build_bsr_int8_direct(W, 14)
        pk = ops.pack_bsr(bsr, dev)
        x = torch.randint(-128, 128, (128, H, H, C), dtype=torch.int8,
                          device=dev).permute(0, 3, 1, 2)
        bias = torch.from_numpy(rng.integers(-3000, 3000, O).astype(
            np.int32)).to(dev)
        f = torch.from_numpy((rng.uniform(0.5, 1.5, O) * 0.4 / np.sqrt(K))
                             .astype(np.float32)).to(dev)
        kw = dict(kernel=k, stride=s, padding=pad, relu=True)
        join = name.endswith(".c2")
        if join:
            kw.update(relu=False, res_scales=(0.02, 0.03, 0.04),
                      residual=torch.randint(
                          -128, 128, (128, Ho, Ho, O), dtype=torch.int8,
                          device=dev).permute(0, 3, 1, 2))

        def chain(x=x, pk=pk, bias=bias, f=f, kw=kw, Ho=Ho):
            a = ops.im2col_nchw(x, kw["kernel"], kw["stride"],
                                kw["padding"]).reshape(128 * Ho * Ho, -1)
            q = ops.bsr_matmul_wt(a, pk, bias=bias, factors=f,
                                  relu=kw["relu"])
            q = q.view(128, Ho, Ho, -1).permute(0, 3, 1, 2)
            if "residual" in kw:
                q = ops.add_residual(q, kw["residual"], *kw["res_scales"],
                                     relu=True).contiguous(memory_format=cl)
            return q

        route = plain = cpk = None
        if hasattr(ops, "bsr_conv2d_int8"):
            # a conv layer's pack: the route's walk, not K4's stages
            cpk = ops.pack_bsr(bsr, dev, conv=True)

            def route(x=x, pk=cpk, bias=bias, f=f, kw=kw):
                return ops.bsr_conv2d_int8(x, pk, bias, f, **kw)

            def plain(x=x, pk=cpk, bias=bias, f=f, kw=kw):
                return ops.bsr_conv2d_int8_plain(x, pk, bias, f, **kw)

        def bound(bsr=bsr, C=C, O=O, H=H, Ho=Ho, join=join,
                  elements=int(mask.sum())):
            macs = 128 * Ho * Ho * elements
            nbytes = (128 * (C * H * H + O * Ho * Ho * (2 if join else 1))
                      + bsr.nnz_blocks * (14 * 14 + 4)
                      + 4 * (bsr.num_block_rows + 1) + 8 * O)
            return max(2 * macs / 1979e12, nbytes / 3.35e12) * 1e3
        yield name, {"route": route, "chain": chain, "plain": plain,
                     "bound": bound}
        del x, pk, cpk


def _ablated(repo: str, name: str) -> str:
    """A copy of ``repo``'s package with ablation ``name`` applied, under
    its build directory; returns the copy's root."""
    pkg = os.path.join(os.path.abspath(repo), "resnet_accel_tpu_torch")
    root = os.path.join(pkg, "_build", f"ablate_{name}")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(pkg, os.path.join(root, "resnet_accel_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for src, old, new in ABLATIONS[name]:
        src = src if "/" in src else os.path.join("csrc", src)
        path = os.path.join(root, "resnet_accel_tpu_torch", src)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise SystemExit(f"kernel_ab: ablation {name} no longer applies "
                             f"to {src}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return root


def _ablation_run(repo: str, iters: int, trunks, name: str,
                  cases=()) -> None:
    """K1 and K10 at batch 128, K2 at ResNet-18's 19 convs, K4's 14 x 14
    cases, K7 at ResNet-50's 16 c3, K8 at the conv sweep's four cases and
    K5 at the prefill, on ``repo``;
    ``cases`` as :func:`_run` takes them."""
    sys.path.insert(0, os.path.abspath(repo))
    import numpy as np
    import torch

    from resnet_accel_tpu_torch import _kernels, ops

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA card")
    dev = torch.device("cuda", torch.cuda.current_device())
    _kernels.build()
    rng = np.random.default_rng(0)

    def want(kernel):
        return not cases or any(kernel.startswith(c) for c in cases)
    if want("K1"):
        print(json.dumps({"ablation": name, "case": K1_CASE,
                          "ms": _time_ms(torch, _k1_call(torch, ops, dev),
                                         iters)}), flush=True)
    for pool in (True, False) if want("K10") else ():
        fn, _ = _k10_call(torch, ops, dev, pool)
        print(json.dumps({"ablation": name, "case": K10_CASES[pool],
                          "ms": _time_ms(torch, fn, iters)}), flush=True)
    for cname, stage, *shape in trunks[18] if want("K2") else ():
        fn = _k2_call(torch, ops, rng, dev, 18, cname, *shape)
        print(json.dumps({"ablation": name, "case": f"K2 resnet18 {cname}",
                          "ms": _time_ms(torch, fn, iters)}), flush=True)
    for case, calls in _k4_cases(torch, ops, rng, dev, small_only=True) if (
            want("K4")) else ():
        ms = sum(_time_ms(torch, lambda: ops.bsr_matmul_wt(A, pk), iters)
                 for A, pk, _ in calls)
        print(json.dumps({"ablation": name, "case": case, "ms": ms}),
              flush=True)
        del calls
    if want("K7"):
        stages = {}
        for stage, fn, _ in _k7_calls(torch, ops, dev):
            stages[stage] = stages.get(stage, 0.0) + _time_ms(torch, fn,
                                                              iters)
        for stage, ms in sorted(stages.items()):
            print(json.dumps({"ablation": name, "case": f"K7 resnet50 stage "
                              f"{stage} batch 128", "ms": ms}), flush=True)
        print(json.dumps({"ablation": name, "case": "K7 resnet50 16 c3 "
                          "batch 128", "ms": sum(stages.values())}),
              flush=True)
    for case, fn, _, _, sweep in _k8_calls(torch, ops, dev) if (
            want("K8")) else ():
        if sweep:   # pair_ms: two calls back to back, the second without
            #         the timed run's start-up after the card's spin
            print(json.dumps({"ablation": name, "case": case,
                              "ms": _time_ms(torch, fn, iters),
                              "pair_ms": _time_ms(
                                  torch, lambda: (fn(), fn()), iters)}),
                  flush=True)
    for case, key, value in _lm_cases(torch, dev) if want("LM") else ():
        print(json.dumps({"ablation": name, "case": case, key: value}),
              flush=True)
    for BH in (8, 64) if want("K5") else ():
        q, k, v = _k5_inputs(torch, dev, BH)
        err = (ops.flash_attention(q, k, v, causal=True)
               - ops.flash_attention_plain(q, k, v, causal=True)).abs().max()
        print(json.dumps({"ablation": name, "case": f"K5 BH {BH}",
                          "ms": _time_ms(torch, lambda: ops.flash_attention(
                              q, k, v, causal=True), iters),
                          "max_abs_err": float(err)}), flush=True)


def _split_sweep(repo: str, iters: int, splits) -> None:
    """K3 and K4 (both paths) at each cluster split of ``splits``, forced
    in place of the wrappers' choice, with the fixed cost of a launch (K4 over a weight
    that stores no block: no K step) and the card's event floor (one
    one-element add)."""
    sys.path.insert(0, os.path.abspath(repo))
    import numpy as np
    import torch

    from resnet_accel_tpu_torch import _kernels, ops
    from resnet_accel_tpu_torch.sparse import build_bsr_int8_direct

    # the wrappers' modules (ops re-exports functions of the same names)
    wrappers = [sys.modules[f"resnet_accel_tpu_torch.ops.{m}"]
                for m in ("bsr_matmul", "matmul_int8")]
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA card")
    dev = torch.device("cuda", torch.cuda.current_device())
    _kernels.build()
    rng = np.random.default_rng(0)

    def i8(shape):
        return torch.randint(-128, 128, shape, dtype=torch.int8, device=dev)

    one = torch.zeros(1, device=dev)
    print(json.dumps({"repo": repo, "case": "event floor (one add)",
                      "ms": _time_ms(torch, lambda: one.add_(1), iters)}),
          flush=True)
    cases = []
    for name, M, K, N in (("K3 fc512", 128, 512, 1000),
                          ("K3 fc2048", 128, 2048, 1000),
                          ("K3 mnist_fc2", 128, 128, 10)):
        a, b = i8((M, K)), i8((N, K)).t()
        cases.append((name, lambda a=a, b=b: ops.matmul_int8(a, b)))
    for name, M, n, s, blk in (
            ("K4 mnist_fc1 0.9", 128, (128, 9216), 0.9, 128),
            ("K4 gemm2048 0.7", 512, (2048, 2048), 0.7, 128),
            ("K4 gemm2048 0.9", 512, (2048, 2048), 0.9, 128),
            ("K4 gemm4096 0.7", 512, (4096, 4096), 0.7, 128),
            ("K4 gemm2048 no block", 512, (2048, 2048), 1.0, 128),
            ("K4 one tile no block", 128, (128, 2048), 1.0, 128),
            ("K4 one tile no block, 14 x 14", 128, (126, 2048), 1.0, 14)):
        W = np.zeros(n, np.int8)
        if s < 1.0:
            W = rng.integers(-128, 128, n).astype(np.int8)
            keep = rng.random((n[0] // 128, n[1] // 128)) >= s
            W *= np.repeat(np.repeat(keep, 128, 0), 128, 1)
        pk = ops.pack_bsr(build_bsr_int8_direct(W, blk), dev)
        A = i8((M, n[1]))
        cases.append((name, lambda A=A, pk=pk: ops.bsr_matmul_wt(A, pk)))
    # the sparse ResNet-18's b0.c1 and b2.c1 at batch 128: two of five
    # block columns stored, int32 out, and int8 out with bias, ReLU and
    # requant as served
    for name, M, N in (("b0.c1", 401408, 64), ("b2.c1", 100352, 128)):
        W = rng.integers(-128, 128, (N, 576)).astype(np.int8)
        W[:, 128:256] = W[:, 384:] = 0
        pk = ops.pack_bsr(build_bsr_int8_direct(W, 128), dev)
        A = i8((M, 576))
        bias = torch.randint(-3000, 3000, (N,), dtype=torch.int32,
                             device=dev)
        f = torch.full((N,), 3e-4, device=dev)
        cases.append((f"K4 {name} int32", lambda A=A, pk=pk:
                      ops.bsr_matmul_wt(A, pk)))
        cases.append((f"K4 {name} int8", lambda A=A, pk=pk, b=bias, f=f:
                      ops.bsr_matmul_wt(A, pk, bias=b, factors=f,
                                        relu=True)))
    # K4's small-block path at its four 14 x 14 cases, each summed
    for name, calls in _k4_cases(torch, ops, rng, dev, small_only=True):
        cases.append((name, lambda calls=calls: [ops.bsr_matmul_wt(A, pk)
                                                 for A, pk, _ in calls]))
    chosen = _kernels.cluster_split
    for split in (None, *splits):
        forced = chosen if split is None else (lambda *_a, s=split, **_k: s)
        for mod in wrappers:
            mod.cluster_split = forced
        for name, fn in cases:
            print(json.dumps({"repo": repo, "case": name,
                              "split": split or "chosen",
                              "ms": _time_ms(torch, fn, iters),
                              "host_ms": _host_ms(torch, fn)}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", action="append", required=True,
                    help="a checkout's root; repeat, in the order to run")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--cases", default="",
                    help="e.g. K1,K2: run only the A/B cases whose name "
                         "starts with one of these")
    ap.add_argument("--splits", default="",
                    help="e.g. 1,2,4,8: time K3 and K4 at each cluster "
                         "split instead of the A/B cases")
    ap.add_argument("--k2-tiles", default="",
                    help="e.g. 64,128: time K2 at each trunk conv with "
                         "each N tile instead of the A/B cases")
    ap.add_argument("--k5-chunks", default="",
                    help="e.g. 1,2,4: time K5 with each chunk size instead")
    ap.add_argument("--sass", action="store_true",
                    help="compare the SASS of the first two checkouts' "
                         "main-loop kernels instead")
    ap.add_argument("--ablate", action="store_true",
                    help="time the kernels with parts knocked out instead")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--trunks", default="{}", help=argparse.SUPPRESS)
    ap.add_argument("--ablation", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        trunks = {int(d): c for d, c in json.loads(args.trunks).items()}
        cases = [c for c in args.cases.split(",") if c]
        if args.ablation:
            _ablation_run(args.repo[0], args.iters, trunks, args.ablation,
                          cases)
        elif args.k5_chunks:
            _k5_chunk_sweep(args.repo[0], args.iters,
                            [int(c) for c in args.k5_chunks.split(",")])
        elif args.k2_tiles:
            _k2_tile_sweep(args.repo[0], args.iters,
                           [int(t) for t in args.k2_tiles.split(",")],
                           trunks)
        elif args.splits:
            _split_sweep(args.repo[0], args.iters,
                         [int(s) for s in args.splits.split(",")])
        else:
            _run(args.repo[0], args.iters, trunks, cases)
        return 0
    if args.sass:
        _sass_compare(args.repo)
        return 0
    # the trunk convs of this script's checkout, for every repo's run
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from resnet_accel_tpu_torch.models.resnet import trunk_convs
    trunks = json.dumps({d: [list(c) for c in trunk_convs(d)]
                         for d in (18, 50)})
    if args.ablate:
        kernels = [c.lower() for c in args.cases.split(",") if c]
        runs = [(args.repo[0], "none")] + [
            (_ablated(args.repo[0], name), name) for name in ABLATIONS
            if not kernels or name.split("_")[0] in kernels]
    else:
        runs = [(repo, "") for repo in args.repo]
    for repo, ablation in runs:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", "--repo", repo, "--iters",
                               str(args.iters), "--splits", args.splits,
                               "--k2-tiles", args.k2_tiles,
                               "--k5-chunks", args.k5_chunks,
                               "--cases", args.cases,
                               "--ablation", ablation, "--trunks", trunks])
        if proc.returncode != 0:
            return proc.returncode
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
