"""Smoke run of the PyTorch port on one CUDA card: dense INT8 ResNet-18
and ResNet-50 serving, block-sparse ResNet-18, the INT8 MNIST CNN, greedy
generation on the INT8 block-sparse decoder LM, the zero-skip conv sweep,
the int8-input stream, ResNet-18 on the space-to-depth stem, the
block-sparse kernels at the reference's 14 x 14 blocks, the probes, the
serving runtime (the native loader's stream, the per-layer profiles, live
power and the typed errors), and the artifact flow: quantize, export, sim,
verify, ``bench --artifact``, the fixture tree, sparse attention and the
gather pack on the card; and LM serving: sampling, speculative decoding
with K5 in its prefill, the continuous and paged-KV batchers, ``score``
and the CLI's ``serve``; and training on the card (torch.autograd): a
ResNet-18 trained, pruned and quantization-aware fine-tuned at ImageNet
geometry, the serving LM trained on the cyclic language and the MNIST CNN
through the CLI's ``train``, each then served through the kernels; and
the parallel programs (``resnet_accel_tpu_torch/parallel``) in spawned
ranks that share the card over gloo, with a world of one NCCL rank.

    python3 chip_smoke.py

Needs one card, nvcc and the repo checkout; exits non-zero (and prints no
result line) without them.  Phases, each fatal on failure:

1. Build the kernels and probes from ``resnet_accel_tpu_torch/csrc`` with
   nvcc.
2. Hold K1-K3 against their plain PyTorch versions on the card, bit for
   bit, at the dense path's shapes and values: a seed-0 ResNet-18
   (ImageNet geometry, 1000 classes), quantized and calibrated on the CPU,
   serving a batch of 128 images of 224 x 224 -- the stem (K1), every conv
   of the trunk including the residual joins (K2) and the fc layer (K3).
   Prints the median kernel and plain times (CUDA events; device time, the
   host's launch time left out), each call's bound and, for K3, its path
   (variant, N tile, cluster split) and the time of ``torch._int_mm``
   plus the bias.  K2 must run its Hopper path (``wgmma_tma``) at every
   conv; its time and bound are printed summed by stage.  (On every phase
   below, the variant counts show K2's path: ``wgmma_tma`` on every conv
   whose input has a multiple of 32 channels, ``mma_sync`` only on the
   space-to-depth stem's 4x4 conv and the MNIST conv1; a served path's
   counts must match exactly.)
3. Serve three batches of 128 through ``InferenceEngine(device="cuda")``
   with every launch count reset to 0 just before; K1-K3 must each have
   launched, K3 on its TMA variant only (the variant counts are printed
   beside the launch counts on every served path).  The logits must be
   finite, [128, 1000], bit-identical to the plain path on the card, and
   for two images bit-identical to the plain path on the CPU.  Prints
   img/s (CUDA events, median forward).
4. Run ``python -m resnet_accel_tpu_torch infer --device cuda`` once for
   ``--model resnet18`` and once for ``--model resnet --depth 50``.
5. ResNet-50 at full width and depth (seed 0, the same geometry and
   batch): walks one batch through the layers and holds K1 at the stem,
   K2 at every c1, c2 and downsample, K7 at each of the 16 c3 (joined by
   the block's proven reciprocal as served, and by the divide: each on
   the Hopper path, ``wgmma_tma``; with K2's time on the same c3 and join
   beside it, the two must agree, and ``torch._int_mm``'s on the c3's
   product alone) and K3 at the fc layer against their plain versions,
   bit for bit.  K7's time, bound, ``_int_mm`` and K2 are printed summed
   by stage and over the 16 c3.
6. Serve three batches of 128 of ResNet-50 through the engine, counts
   reset just before: K1, K2, K3 and K7 must launch, K7 16 times a batch,
   every one on ``wgmma_tma``.
   The logits must be finite, [128, 1000], bit-identical to the plain path
   on the card and for two images on the CPU.  Prints img/s.
7. Sparse ResNet-18: the ResNet-18 weights block-pruned at 0.7 with
   128 x 128 blocks, quantized, BSR attached at 128 (``min_sparsity``
   0.25).  Walks one batch of 128 through the layers and holds K4 against
   its plain version at each sparse conv, bit for bit; prints K4's path,
   the im2col, K4, plain, ``torch._int_mm`` on the densified weight and
   the dense K2 times of the same pruned conv.  K4's bound counts only
   the columns of A under block columns that some block row stores.
8. Serve three batches of 128 through the engine on the sparse model,
   counts reset just before: K1, K2, K3 and K4 must each launch, K4 and
   K3 on their Hopper (TMA) variants only.  The logits must be
   bit-identical to the plain path on the card, for two images to the
   plain path on the CPU, and to the dense forward of the same pruned
   model.  Prints both forwards' img/s (CUDA events, median), in the order
   dense, sparse, sparse, dense.
9. The MNIST CNN from seeded arrays written in the reference's int8
   export layout, fc1 block-pruned at 0.9, batch 128: K4 against its plain
   version at fc1 (one block row of 9 blocks: a split-K cluster of two);
   K3 at the dense fc1 (with requant and ReLU) and at fc2 (N = 10), each
   beside ``_int_mm`` plus the bias where cuBLAS takes the shape; the
   engine's logits (counts reset just before; K2, K3 and K4 must launch,
   on their Hopper variants) bit-identical to the plain path on the card
   and on the CPU.
10. ``python -m resnet_accel_tpu_torch bench --sizes 2048,4096
   --sparsities 0.0,0.5,0.7,0.9 --batch 512 --device cuda`` and
   ``infer --model mnist --weights <dir> --device cuda``, as subprocesses.
11. The repo's serving LM (``LM_CFG``: d_model 512, 8 heads, d_ff 1024,
   4 layers, vocab 256, max_len 1024, 80 % sparse 8 x 8 blocks), seed 0,
   calibrated on 16 seeded tokens on the CPU; a seeded 640-token prompt
   and eight more.
12. K5 against its plain version within rtol = atol = 2e-5 at each of the
   four layers' q, k, v of the prefill, for one prompt (BH 8) and for the
   eight (BH 64), T 640, dh 64, causal; beside it the time and error of
   ``scaled_dot_product_attention`` (float32, TF32 off), which the port
   never calls.
13. ``generate(flash=True)`` 640 -> 256 for the one prompt and for the
   eight batched, counts reset just before: K5 must launch 4 times a
   prefill.  The tokens must equal the plain path on the card, each
   batched row its own single-prompt run, and the prefill's logits must be
   finite and within 1e-4 of the plain path.  Prints prefill ms, decode ms
   a step and tokens/s, and a ``torch.profiler`` breakdown of one prefill
   and of 32 decode steps.
14. ``generate --flash`` as a subprocess with the same model and prompt:
   its tokens must equal ``generate(flash=True)``'s.
15. The conv sweep's four cases (ResNet-18's strided convs at ImageNet
   widths, batch 64, tap blocks zeroed at 0.7, seed 1): K8 against its
   plain version and against the dense K2 on the same weights, bit for
   bit, with K8's route, K8's, the plain and K2's times, K8's bound and
   ``speedup_vs_dense`` for each case; K8 must run its Hopper route
   (``wgmma_tma``) at all four.  Then ``bench --conv --device cuda`` in
   this process, counts reset just before (K8 and K2 must launch, both
   on ``wgmma_tma`` only), and as a subprocess; each must print four
   JSON lines.
16. K10 at ResNet-18's stem, batch 128, 224 x 224, on ``quantize_input``
   of the seed-0 images and the packed weight the model serves: pooled
   and unpooled against the plain version (both timed), and pooled
   against K1 on the fp32 images, bit for bit; then at the card tests'
   geometries (odd and even W, batch 12), saturated values included, on
   the OIHW and the packed weight.
17. The int8 stream: three batches of 128 quantized on the host through
   ``InferenceEngine(device="cuda").stream``, counts reset just before:
   K10, K2 and K3 must launch and K1 must not.  The logits must be finite,
   [128, 1000] a batch, bit-identical to the plain path on the card, to
   the fp32-input forward of the same images and for two images to the
   plain path on the CPU.  Prints the stream's img/s and the int8- and
   fp32-input forwards' times, in the order fp32, int8, int8, fp32.
18. K6 at the batch-128 stem on the seed-0 images, on exact rounding ties
   and saturating values, and at batches 1 and 3, against its plain
   version, bit for bit; its time, plain time and bound.
19. The space-to-depth stem (K6, K2's 4x4 conv on ``stem_s2d_weights``
   padded ((2, 1), (2, 1)), the max pool) against K1 on the same images,
   bit for bit, with the time of each part beside K1's.
20. Three batches of 128 through ``InferenceEngine(device="cuda",
   stem_fused=False)``, counts reset just before: K6, K2 and K3 must
   launch and K1 must not.  The logits must be finite, bit-identical to
   the plain path on the card, to the default (K1) route and for two
   images to the plain path on the CPU; a batch of 100 and an int8 batch
   on the route must equal the default route.  Prints both routes'
   img/s, in the order default, s2d, s2d, default.
21. K4 at 14 x 14 blocks, on its small-block path ``wgmma_small`` (the
   served runs must launch no other): the MNIST CNN's fc1 (against its
   plain version; the engine's logits against the plain path on the card
   and the CPU, counts reset just before), the GEMM M = 512, N = K = 2048
   at 0.7 (with the 128 x 128 case beside it), and the seed-0 ResNet-18
   pruned 0.7 at 14 x 14 at batch 8 (K4 against plain at each sparse
   conv, with its bound and ``_int_mm`` on the densified weight, and the
   128 x 128 model's; the engine's logits against the plain path and the
   dense forward of the pruned model).  Then the same model at batch 128
   (no plain path at this size): at each of its 19 convs K4 in int32
   against ``_int_mm`` on the densified weight (exact), both timed, and
   the JAX package's recipe beside it -- the conv's 14 x 14 blocks
   regrouped to 128 x 128 (``sparse/regroup.py``) on K4's Hopper path,
   bit for bit against the native path, with each conv's
   ``effective_density``; three batches through the engine (counts reset
   just before, K4 on ``wgmma_small`` only), logits against the dense
   forward of the pruned model; both forwards' img/s in the order dense,
   sparse, sparse, dense.
22. K8 at block_c 16, block_o 14 on the sweep's l3.c1 and l4.ds, against
   its plain version and the dense K2, bit for bit, on its ``mma_sync``
   route (the only one those blocks take).
23. The probes (``resnet_accel_tpu_torch/probes.py``): ``mma_s8_rate`` at
   K1's and K2's GEMM shapes, ``chain_rate`` (int32 max, f32 requant) and
   the stem's tensor-core tile, pooled on fp32 input, with stages knocked
   out (whole, it equals K1), timed beside K1 and K10, each on a line of
   its own; ``tma_box``
   at inner coordinates 0, 16 and 48 against its plain version, and at 14
   (the 14 x 14 blocks' K offset) in a process of its own, which must fail
   with an illegal instruction: the reason K4's small-block path loads
   32-byte windows from 16-byte boundaries.
24. The native stream: the host library built from ``native/src`` by
   ``g++`` (a failed build fails the phase); 384 seeded uint8 ImageNet
   images, served as three batches of 128 through ``stream`` over
   ``native.BatchLoader`` (in order, ImageNet mean and std, the model's
   ``s_input``, ``os.cpu_count()`` threads), counts reset just before:
   K10, K2 and K3 must launch and K1 must not.  The logits must be
   bit-identical to the ``QuantizingLoader`` stream of
   ``preprocess_imagenet`` of the same images and to the plain path on
   the card, the labels the images'.  Prints both loaders' img/s over 12
   batches in the order QuantizingLoader, native, native, QuantizingLoader,
   and ``run_inference``'s upload of a batch timed from pageable memory
   and through a pinned buffer, in the order pageable, pinned, pinned,
   pageable.
25. ``InferenceEngine.profile`` (the CUDA-event forward over the roofline
   rows) and ``xprof.profile_layers`` (device time by ``record_function``
   scope) for ResNet-18 and ResNet-50 at batch 128: every row's scope and
   ``pool`` must have device time, the scopes must sum to within 10 % of
   the forward's CUDA-event median, and at most 5 % of it may reach no
   scope (printed); then ``profile --batch 128`` and ``profile --measured
   --depth 50 --batch 128`` as subprocesses.
26. Power: ``power.PowerSampler`` over 2.5 s of back-to-back ResNet-18
   forwards at batch 128 (``nvidia-smi``'s ``power.draw.instant``, or
   ``power.draw``, and ``clocks.sm``): a ``PowerProfile`` with
   ``modeled=False``, average and peak W, the SM clock and GOPS/W, beside
   the idle reading taken before any load and the modeled estimate.
27. The typed errors on the card: a 3-D input and ``n_batches=0`` raise
   ``INVALID_CONFIG``, ``timeout_s=0`` raises ``TIMEOUT``.
28. The artifact flow, the CLI as subprocesses: ``quantize`` of a seeded
   fp32 MNIST checkpoint (the JAX names and shapes, nonzero biases), then
   ``infer --model mnist`` on it (its classes the engine's; the engine's
   logits, counts reset just before, bit-identical to the plain path);
   the quantized fc1 [128, 9216] with 14 x 14 blocks zeroed at 0.9,
   ``export``-ed and ``sim``-ulated; K4 on the layer regrouped to 128 x
   128 (``wgmma_tma``) with ``sim``'s activation, saved and passed by
   ``verify``, which must fail a copy with one value flipped; ``bench
   --artifact --chain 256`` in this process at M 1 and 128, and on the
   unpruned fc1 (6,590 blocks of 14 x 14, the reference's FC1 count) at M
   1 (counts reset just before: K4 on ``wgmma_tma`` only,
   ``bit_exact``), each beside K4 against its plain version, its bound
   and ``_int_mm`` (M padded to 32);
   ``fixtures --seed 42``, then ``SparseAttentionInt8`` of
   ``transformer/80pct`` and ``90pct`` at T 8 and 640 on the card against
   ``forward_golden`` and the CPU (rtol 2e-4, atol 2e-5); the gather pack
   on the card (the 2048 GEMM's weight at 0.7 with 128 x 128 blocks, the
   14 x 14 fc1), its product equal to the host pack's, a too-small
   ``lmax`` raising.
29. LM serving on phase 11's LM, each run with the counts reset just
   before (K5 must launch 4 times a prefill, and never on a batcher):
   ``generate_speculative(flash=True)``, greedy, draft 15, 640 -> 256 on
   the seeded prompt and on a seeded 40-token motif repeated to 640
   tokens, its tokens equal to ``generate(flash=True)``'s (phase 13's on
   the seeded prompt); ``sample(flash=True)`` at temperature 0.8, top-k 40,
   deterministic for seed 0, different for seed 1, equal to greedy at top-k
   1; sampled speculation deterministic for its seed.  Then eight
   640-token requests, 64 new tokens each, through ``ContinuousBatcher``
   (8 slots, chunk 8) and ``PagedKVBatcher`` (page 16, a pool smaller than
   slots x max_len; and with ``spec_draft`` 7), their greedy streams equal
   to ``generate(parallel_prefill=False)``'s (batched; each row its own
   run); two requests sharing 608 prompt tokens one after the other through
   the ``ondemand`` engine with the prefix cache (the second skips those
   608 prefill steps; streams equal); int8 KV pages (agreement printed, not
   required: lossy by design); ``score()`` within 1e-4 of the teacher-forced
   forward.  Logits, not only tokens (this random LM's greedy stream
   repeats its newest token, so wrong positions or pages could keep the
   argmax): the first request's logits at each of its 703 positions, one
   decode step a token on a cache of its own, against 16-row
   ``verify_step`` passes over the same tokens, against its slot's rows
   in every ``ContinuousBatcher`` micro-step and in every chunked
   ``PagedKVBatcher`` micro-step, and against the rows of its
   ``spec_draft`` windows fed the same tokens (each within 1e-6; the rows
   not bit for bit counted).  Prints tokens/s on the host clock, verify
   passes and engine steps.  Then ``generate --flash --speculative`` and ``serve`` as
   subprocesses, their tokens equal to the module's.
30. Training on the card (``resnet_accel_tpu_torch/train``, float32, TF32
   off), each model served after.  ResNet-18 at ImageNet geometry (224 x
   224, 1000 classes, seed 0) on 256 seeded images with a class-dependent
   patch (four classes): the first step's loss and gradients at 4 images,
   the card against the CPU in float64 (within 1e-9), and each float32 run
   against float64 in L2 (the card with cuDNN off within 1e-3, with cuDNN,
   as it trains, within 1e-2; the CPU's printed); one epoch of
   ``train_resnet18`` at batch 32 (SGD; the loss finite, more than 30
   running statistics moved), then a second timed by CUDA events (ms a
   step, img/s), and a ``torch.profiler`` breakdown of two steps;
   ``prune_blocks_global`` at 0.7 (normalized, by parameters,
   tools/accuracy_curve.py's block configurations), two masked steps with
   the group lasso and two ``qat_finetune_resnet`` steps, every pruned
   weight exactly 0 and the running statistics frozen by QAT;
   ``quantize_resnet18`` (16 calibration images) and
   ``attach_bsr(block=128, min_sparsity=0.25)``, one batch of 128 served,
   counts reset just before: K1, K2, K3 and K4 must launch (K2, K3 and K4
   on ``wgmma_tma`` only), the logits bit-identical to the plain path and
   to the dense serving of the same model.  The serving LM (phase 11's
   width, seed 0) trained by ``train_lm`` (300 steps of 16 x 128 tokens;
   the mean of the last 20 losses below half the first 20's; tokens/s by
   CUDA events; a profile of 5 steps; the float32 next-token accuracy on
   sequences of the trained length printed), ``prune_lm_blockwise(0.8,
   8)``, ``quantize_lm``, calibrated on 64 tokens,
   ``generate(flash=True)`` from a 640-token cyclic prompt, 64 new: K5
   must launch 4 times, the tokens equal the plain path's (the share that
   follows the affine rule printed).  MNIST: a seeded synthetic t10k split
   of 2,048 images in IDX files, then ``train --epochs 1 --prune
   --schedule 0.5,0.7``, ``quantize`` and ``infer --model mnist`` as
   subprocesses on the card; ``qat_finetune`` for an epoch on that
   checkpoint with fc1's zero 128 x 128 blocks kept at 0, ``export_qat``
   -> ``with_fc1_bsr(128)`` served, counts reset just before: K2, K3 and
   K4 must launch (K3, K4 on ``wgmma_tma``), the logits bit-identical to
   the plain path; ``CheckpointManager`` keeps the newest two of three.
31. Parallelism (``resnet_accel_tpu_torch/parallel``, ``launch.run_world``):
   one world of four ranks spawned on ``cuda:0`` over gloo (the card's
   machine has one card and NCCL takes a card a rank), which runs in turn:
   ``make_data_parallel_forward`` of the phase-3 ResNet-18 and of the
   phase-8 sparse ResNet-18 on batch 0 (32 images a rank through K1, K2,
   K3 and, sparse, K4 in every rank, counts reset just before; the
   all-gathered logits bit-identical to the single-rank engine's; the
   rank's forward timed by CUDA events, the whole program by the host
   clock); the dp BSR GEMM (M 512 over the ranks, N = K = 2048, 128 x 128
   blocks at 0.9: K4 in every rank, bit-identical to the golden and to K4
   on one rank); ``PagedKVBatcher(tp_mesh=dp 2 x tp 2)`` with int8 KV and
   spec_draft 7 on phase 11's LM, eight 640-token requests, 64 new each
   (streams equal the single-rank int8 engine's); ``make_tp_lm_generate(
   batched=True)`` on (dp 2, tp 2), four of the prompts 640 -> 64 (tokens
   equal ``generate(parallel_prefill=False)``'s); sp 4 on the LM's first
   block at T 640 (within 2e-3 of the block on one rank); ep 4 on
   ``MoEBlockInt8.from_random(n_experts=4)`` (bit for bit); the MNIST
   pipeline and ``combined`` on (dp 1, pp 2, tp 2) (within 1e-4 of the
   unsharded forward) and one ``combined`` Adam step (its loss within
   1e-5); the dry run of every program.  Then a world of one NCCL rank
   (the tp 1 paged engine, streams equal ``generate``'s), ``serve --tp 2``
   refused over NCCL on one card, and ``serve --tp 2 --dist-backend gloo
   --spec-draft 7`` (a world of its own: its streams equal the single-rank
   engine's).  Each world prints its backend and devices; a failing rank
   fails the phase.  Prints K1-K4's launches summed over the ranks, which
   the kernels line adds.

The line before the last is ``{"kernels": [...]}`` (launches summed over
the served paths, phase 24's stream, phase 28's ``bench --artifact`` (its
CUDA graphs' replays counted by hand), phase 29's decoders, phase 30's
served models and phase 31's ranks included; ms
the kernel's time summed over the shapes of the paths walked: ResNet-18
and ResNet-50 for K1-K3, the sparse ResNet-18 for K4, ResNet-50 for K7,
the four layers of one prompt's prefill for K5, the sweep's four cases
for K8, the pooled and unpooled stem for K10, the batch-128 stem for K6;
bound_ms the sum over the same calls of the larger of bytes / 3.35 TB/s
and operations / the peak of their type, K5's at the 3xTF32 rate it runs;
library_ms the PyTorch call timed beside the kernel, summed the same way,
or null); the last is ``{"ok": true, "device": {...}}``.  Every time printed is
labelled with the card's name and power limit.
"""

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

BATCH = 128
HW = 224
CLASSES = 1000
SEED = 0
SPARSITY = 0.7          # block pruning of the sparse ResNet-18
BLOCK = 128
MNIST_FC1_SPARSITY = 0.9
MNIST_SHAPES = {"conv1": (32, 1, 3, 3), "conv2": (64, 32, 3, 3),
                "fc1": (128, 9216), "fc2": (10, 128)}
# The repo's serving LM (tools/lm_corpus.py, tools/spec_bench.py): d_model
# 512, 8 heads, d_ff 1024, 4 layers, vocab 256, max_len 1024, 8 x 8 blocks,
# 80 % block sparsity; served with a 640-token prompt and 256 new tokens.
LM_CFG = dict(vocab=256, d_model=512, n_heads=8, d_ff=1024, n_layers=4,
              max_len=1024, sparsity=0.8, block=8)
PROMPT, N_NEW, LM_BATCH = 640, 256, 8
# The conv sweep (bench --conv, tools/tune_tpu.py's): batch and tap-block
# sparsity.
SWEEP_BATCH, SWEEP_SPARSITY = 64, 0.7


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    raise SystemExit(1)


def bsr_work(a, pk, out):
    """Bytes and int8 operations of one K4 call, counted from its stored
    blocks.  In: the columns of A under the block columns that some block
    row stores (each once; the last block column stops at K), the stored
    blocks and their indices, bias and factors.  Out: the output.  The
    products of the stored blocks only."""
    M, K = a.shape
    bw = pk.block_w
    a_cols = sum(min(bw, K - c * bw)
                 for c in torch.unique(pk.col_idx).tolist())
    nbytes = (M * a_cols + pk.blocks.numel() + 4 * (pk.row_ptr.numel()
              + pk.col_idx.numel()) + 8 * pk.n_out
              + out.numel() * out.element_size())
    return nbytes, 2 * M * pk.blocks.numel(), "int8"


def plan_text(plan) -> str:
    """A K3, K4, K7 or K8 call's path, as printed beside its time."""
    return (f"[{plan.variant}"
            + (f" N tile {plan.bn}" if plan.bn else "")
            + f" split {plan.split}]")


def sconv_work(x, pk, stride, out):
    """Bytes and int8 operations of one K8 call, counted from its stored
    blocks.  In: for each channel block that some stored block reads, the
    input pixels its stored taps reach inside the image (each once); the
    stored blocks and their indices; the factors.  Out: the output.  The
    products: each stored block at the output pixels whose tap lies inside
    the image (none with no stored block)."""
    N, C, H, W = x.shape
    _, O, Ho, Wo = out.shape
    p = pk.padding

    def reach(k, n_out, n_in):      # input rows or columns of tap k
        r = np.arange(n_out) * stride + k - p
        return r[(r >= 0) & (r < n_in)]
    taps = {}
    for kh, kw, cb in zip(pk.kh.tolist(), pk.kw.tolist(), pk.cb.tolist()):
        taps.setdefault(cb, set()).add((kh, kw))
    pixels = 0
    for tset in taps.values():
        seen = np.zeros((H, W), bool)
        for kh, kw in tset:
            seen[np.ix_(reach(kh, Ho, H), reach(kw, Wo, W))] = True
        pixels += int(seen.sum())
    nbytes = (N * pk.block_c * pixels + pk.blocks.numel()
              + 4 * (pk.o_ptr.numel() + 3 * pk.nnz_source) + 4 * O
              + out.numel() * out.element_size())
    valid = sum(reach(kh, Ho, H).size * reach(kw, Wo, W).size
                for kh, kw in zip(pk.kh.tolist(), pk.kw.tolist()))
    return nbytes, 2 * N * pk.block_c * pk.block_o * valid, "int8"


#: Clock cycles the card spins (about 2.5 ms) before each timed run, so
#: that the host has queued the whole run before its start event fires.
SPIN_CYCLES = 5_000_000
#: The spin before a whole forward (about 20 ms): a ResNet-50 forward's
#: launches alone can take the host longer than ``SPIN_CYCLES`` when the
#: host's cores are shared.
FORWARD_SPIN_CYCLES = 40_000_000


def time_ms(fn, iters: int, spin: int = SPIN_CYCLES) -> float:
    """Median device time of ``fn`` over ``iters`` runs, after one warm-up:
    CUDA events around each run, recorded behind a spin of the card of
    ``spin`` clock cycles, so the host's time to launch ``fn`` is not
    counted."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


#: The card's published peaks (NVIDIA's H100 SXM data sheet; dense rates at
#: the 700 W limit): device memory, int8 tensor cores, float32 FFMA, and
#: float32 products in three TF32 tensor-core passes (3xTF32, K5's: a third
#: of the 495 TFLOP/s TF32 rate).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"int8": 1979e12, "fp32": 67e12, "tf32x3": 495e12 / 3}


def bound_ms(nbytes: float, ops: float, kind: str):
    """The least time the card could take to move ``nbytes`` (each input
    read once, each output written once) and to do ``ops`` operations of
    ``kind``: (bytes ms, operations ms)."""
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S[kind] * 1e3


def int_mm_call(a: torch.Tensor, w_nk: torch.Tensor):
    """``torch._int_mm`` of int8 a [M, K] and the int8 weight w [N, K] (as
    its column-major transpose), or None where cuBLAS's int8 GEMM does not
    take the shape (M > 16, K and N multiples of 8)."""
    M, K = a.shape
    if M <= 16 or K % 8 or w_nk.shape[0] % 8 or not a.is_contiguous():
        return None
    wt = w_nk.contiguous().t()
    return lambda: torch._int_mm(a, wt)


def densify(pk) -> torch.Tensor:
    """The dense int8 weight [n_out, k_dim] of a ``PackedBSR``."""
    bh, bw = pk.block_h, pk.block_w
    nbr, nbc = pk.n_padded // bh, pk.k_padded // bw
    rows = torch.repeat_interleave(
        torch.arange(nbr, device=pk.blocks.device), pk.row_ptr.diff().long())
    grid = torch.zeros((nbr, nbc, bh, bw), dtype=torch.int8,
                       device=pk.blocks.device)
    grid[rows, pk.col_idx.long()] = pk.blocks
    return grid.permute(0, 2, 1, 3).reshape(pk.n_padded, pk.k_padded)[
        :pk.n_out, :pk.k_dim]


def served_launches(_kernels, run, must: list, what: str,
                    paths: dict = None) -> dict:
    """Counts of one served path: reset just before ``run()``, read just
    after; every kernel in ``must`` has to have launched, and each kernel
    in ``paths`` on the variant named there only, or, where ``paths``
    gives a dict, exactly that many times on each variant."""
    _kernels.reset_launch_counts()
    out = run()
    counts = _kernels.launch_counts()
    variants = _kernels.variant_counts()
    print(f"launch counts, {what}: {counts}; variants: {variants}")
    for name in must:
        if counts[name] == 0:
            fail(f"kernel {name} was never launched by {what}")
    for name, variant in (paths or {}).items():
        got = variants.get(name, {})
        if (got != variant if isinstance(variant, dict)
                else set(got) - {variant}):
            fail(f"{what}: {name} took {got}, not {variant}")
    return out, counts


def paths_since(_kernels, kernel: str, before: dict, expect: str,
                what: str) -> dict:
    """``kernel``'s launches since ``before`` (its variant counts then):
    every one on the path ``expect``."""
    after = _kernels.KERNELS[kernel].variants
    grew = {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0)}
    if not grew or set(grew) - {expect}:
        fail(f"{what}: {kernel} took {grew}, not only {expect}")
    print(f"{kernel} paths, {what}: {grew}")
    return grew


def mnist_int8_dir(path: str, seed: int) -> None:
    """Write a seeded MNIST CNN in the reference's int8 export layout:
    He-init float weights quantized per channel (fc1's 128 x 128 blocks
    zeroed with probability MNIST_FC1_SPARSITY), int8 biases with a
    per-tensor scale."""
    from resnet_accel_tpu_torch.quant import quantize_symmetric_per_channel
    rng = np.random.default_rng(seed)
    for layer, shape in MNIST_SHAPES.items():
        fan_in = int(np.prod(shape[1:]))
        w = rng.normal(0, np.sqrt(2.0 / fan_in), shape).astype(np.float32)
        if layer == "fc1":
            mask = rng.random((1, 72)) < MNIST_FC1_SPARSITY
            w[np.repeat(np.repeat(mask, 128, 0), 128, 1)] = 0.0
        q, s = quantize_symmetric_per_channel(w)
        b = rng.normal(0, 0.05, shape[0]).astype(np.float32)
        b_scale = float(np.abs(b).max()) / 127.0
        np.save(os.path.join(path, f"{layer}_weight_int8.npy"), q)
        np.save(os.path.join(path, f"{layer}_weight_scales.npy"), s)
        np.save(os.path.join(path, f"{layer}_bias_int8.npy"), np.clip(
            np.rint(b / b_scale), -128, 127).astype(np.int8))
        with open(os.path.join(path, f"{layer}_bias_scale.json"), "w") as f:
            json.dump({"scale": b_scale}, f)


def profiled(what, fn, label):
    """Device time by kernel under torch.profiler for one ``fn()``
    (the device's own events only: an operator's row repeats the time
    of the kernels it launched)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        span = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type != DeviceType.CPU
            and e.self_device_time_total > 0]
    busy = sum(r[1] for r in rows)
    if busy == 0:
        print(f"profile, {what}: no device time recorded (not measured)")
        return
    print(f"profile, {what}: span {span:.3f} ms, device busy "
          f"{busy:.3f} ms, idle share {1 - busy / span:.4f}  ({label})")
    for key, ms, n in sorted(rows, key=lambda r: -r[1])[:10]:
        print(f"    {ms:9.3f} ms {100 * ms / busy:5.1f} %  {n:5d}x  "
              f"{key[:90]}")


#: Phase 30: ResNet-18 trained at ImageNet geometry on TRAIN_N synthetic
#: images (the class-dependent patch of tests/test_train_resnet18.py,
#: scaled to 224), four classes of the 1000 outputs.
TRAIN_N, TRAIN_BATCH, TRAIN_CLASSES = 256, 32, 4
#: The serving LM trained on the cyclic language.
LM_TRAIN = dict(seq_len=128, batch=16, steps=300)
MNIST_TRAIN_N = 2048


def cuda_timed(fn):
    """(fn(), seconds) between CUDA events recorded around the call (it
    ends in a copy to the host)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) / 1e3


def resnet_prune_cfgs(params, BlockCfg):
    """tools/accuracy_curve.py's block configurations (make_cfgs): every
    trunk conv but the downsamples, 128 x 128 blocks keeping 2 % where it
    has 256 channels or more, 32 x 32 keeping 10 % at 128, and the default
    32 x 32 keeping 30 % at 64."""
    cfgs = {}
    for k, v in params.items():
        if not (k.endswith(".weight") and v.ndim == 4
                and "downsample" not in k and k != "conv1.weight"):
            continue
        if v.shape[0] >= 256:
            cfgs[k] = BlockCfg(128, 128, 0.02)
        elif v.shape[0] >= 128:
            cfgs[k] = BlockCfg(32, 32, 0.10)
        else:
            cfgs[k] = BlockCfg(32, 32, 0.30)
    return cfgs


def train_phase(repo: str, dev, label: str, _kernels) -> dict:
    """Phase 30: the port's trainers on the card, each model then served
    through the kernels.  Returns the launch counts of its served paths."""
    import torch.nn.functional as F
    from resnet_accel_tpu_torch.models.mnist_cnn import MNISTCNNInt8
    from resnet_accel_tpu_torch.models.resnet18 import (attach_bsr,
                                                        init_resnet18_fp32,
                                                        quantize_resnet18)
    from resnet_accel_tpu_torch.runtime.engine import (InferenceEngine,
                                                       preprocess_mnist)
    from resnet_accel_tpu_torch.train import (BlockCfg, expand_mask,
                                              export_inference_params,
                                              export_qat, make_group_lasso_fn,
                                              make_mask_fn, qat_finetune,
                                              prune_blocks_global,
                                              train_resnet18)
    from resnet_accel_tpu_torch.train.checkpoint import CheckpointManager
    from resnet_accel_tpu_torch.train.lm import (cyclic_sequences,
                                                 init_lm_fp32,
                                                 lm_forward_fp32,
                                                 prune_lm_blockwise,
                                                 quantize_lm, train_lm)
    from resnet_accel_tpu_torch.train.mnist import load_checkpoint, to_device
    from resnet_accel_tpu_torch.train.qat import qat_finetune_resnet
    from resnet_accel_tpu_torch.train.resnet18 import (resnet18_forward,
                                                       split_params)
    from resnet_accel_tpu_torch.utils.mnist_data import (load_mnist_split,
                                                         save_idx_split,
                                                         synthetic_digits)
    t30 = time.perf_counter()
    launches = dict.fromkeys(_kernels.KERNELS, 0)

    def add(counts):
        for k, n in counts.items():
            launches[k] += n

    # 30.1 ResNet-18 at ImageNet geometry: data, one dense epoch
    rng = np.random.default_rng(SEED + 40)
    y = rng.integers(0, TRAIN_CLASSES, TRAIN_N)
    x = rng.normal(0, 0.3, (TRAIN_N, 3, HW, HW)).astype(np.float32)
    h = HW // 2
    for i, c in enumerate(y):
        x[i, c % 3, (c // 3) * h:(c // 3) * h + h, :h] += 2.0
    init = init_resnet18_fp32(seed=SEED, num_classes=CLASSES)
    p0, s0 = split_params(init)

    # The first step's loss and gradients at 4 images.  Card against CPU
    # in float64: within 1e-9.  Not in float32 at the CPU tests' 1e-5: at
    # 224 x 224 a weight's gradient sums up to 50,176 products and
    # BatchNorm's backward cancels most of them, so float32 is off float64
    # by up to 6e-4 of a gradient's largest entry with direct convolutions
    # and 2e-2 with cuDNN's algorithms on an H100 (this phase prints both).
    # So each float32 run is held to float64 in L2: the card with cuDNN off
    # within 1e-3, as it trains (cuDNN) within 1e-2; the CPU's printed.
    def first_step(device, dtype=torch.float32):
        p = {k: torch.tensor(v, device=device, dtype=dtype,
                             requires_grad=True) for k, v in p0.items()}
        s = {k: torch.from_numpy(v).to(device, dtype) for k, v in s0.items()}
        logits, _ = resnet18_forward(
            p, s, torch.from_numpy(x[:4]).to(device, dtype), False, True)
        loss = F.cross_entropy(logits, torch.from_numpy(y[:4]).to(device))
        loss.backward()
        return (float(loss.detach()),
                {k: v.grad.double().cpu().numpy() for k, v in p.items()})

    def off(got, ref, what, rtol, rel_atol=0.0, l2=None):
        """Print the worst gradient of ``got`` against ``ref`` by its
        largest entry and in L2; fail beyond the tolerance."""
        (lg, g), (lr, r) = got, ref
        w = max((np.abs(g[k] - r[k]).max() / np.abs(r[k]).max(), k)
                for k in r)
        w2 = max((np.linalg.norm(g[k] - r[k]) / np.linalg.norm(r[k]), k)
                 for k in r)
        ok = np.isclose(lg, lr, rtol=max(rtol, 1e-6)) and (
            w2[0] <= l2 if l2 is not None else all(np.allclose(
                g[k], r[k], rtol=rtol, atol=rel_atol * np.abs(r[k]).max())
                for k in r))
        print(f"ResNet-18 {HW} x {HW}, the first step at 4 images, {what}: "
              f"loss {lg:.9f} vs {lr:.9f}; the worst of {len(r)} gradients "
              f"by its largest entry {w[1]} {w[0]:.3g}, in L2 {w2[1]} "
              f"{w2[0]:.3g}: {'within' if ok else 'BEYOND'} the tolerance")
        return ok
    g64, cpu64 = first_step(dev, torch.float64), first_step(
        "cpu", torch.float64)
    checks = [
        (cpu64, g64,
         "the CPU against the card in float64", 1e-9, 1e-9, None),
        (None, g64, "the card in float32 with cuDNN off against float64",
         0.0, 0.0, 1e-3),
        (first_step(dev), g64, "the card in float32 (cuDNN, as it trains) "
         "against float64", 0.0, 0.0, 1e-2)]
    with torch.backends.cudnn.flags(enabled=False):
        checks[1] = (first_step(dev),) + checks[1][1:]
    if not all([off(*c) for c in checks]):
        fail("the first training step is off float64 on the card")
    off(first_step("cpu"), cpu64,
        "the CPU in float32 against float64 (printed only)", 0.0, l2=1.0)

    kw = dict(batch_size=TRAIN_BATCH, num_classes=CLASSES,
              small_input=False, seed=SEED, device=dev)
    st, dt = cuda_timed(lambda: train_resnet18(x, y, epochs=1, init=init,
                                               **kw))
    moved = sum(not np.allclose(st.bn_state[k], s0[k]) for k in s0)
    loss = st.history[-1]["loss"]
    print(f"train_resnet18, 1 epoch ({TRAIN_N // TRAIN_BATCH} steps of "
          f"{TRAIN_BATCH}, SGD): loss {loss:.4f}, train acc "
          f"{st.history[-1]['train_acc']:.4f}, {moved} of {len(s0)} running "
          f"stats moved; {dt:.3f} s (first call)")
    if not np.isfinite(loss) or moved <= 30:
        fail(f"dense training: loss {loss}, {moved} running stats moved")
    _, dt = cuda_timed(lambda: train_resnet18(x, y, epochs=1, init=init,
                                              **kw))
    steps = TRAIN_N // TRAIN_BATCH
    print(f"ResNet-18 training, {HW} x {HW}, batch {TRAIN_BATCH}: "
          f"{dt / steps * 1e3:.2f} ms a step, {TRAIN_N / dt:.1f} img/s "
          f"(CUDA events over one epoch of {steps} steps, the images' "
          f"upload included)  ({label})")
    profiled(f"train_resnet18, 2 steps of {TRAIN_BATCH}",
             lambda: train_resnet18(x[:2 * TRAIN_BATCH],
                                    y[:2 * TRAIN_BATCH], epochs=1,
                                    init=init, **kw), label)

    # 30.2 pruning at 0.7 (normalized, by parameters), two masked steps
    # with the group lasso, two QAT steps
    flat = export_inference_params(st)
    cfgs = resnet_prune_cfgs(st.params, BlockCfg)
    shapes = {k: st.params[k].shape for k in cfgs}
    masks = prune_blocks_global({k: st.params[k] for k in cfgs}, 0.7, cfgs,
                                normalize=True, by_params=True)
    mask_fn = make_mask_fn(masks, cfgs, shapes)
    pst = train_resnet18(x[:64], y[:64], epochs=1, init=flat, lr=0.01,
                         mask_fn=mask_fn, reg_fn=make_group_lasso_fn(cfgs),
                         **kw)

    def masked_zero(params, what):
        for k in cfgs:
            dead = expand_mask(masks[k], cfgs[k], shapes[k]) == 0
            if not np.all(params[k][dead] == 0):
                fail(f"{what}: {k} has nonzero weights in pruned blocks")
    masked_zero(pst.params, "masked training")
    flat_q = qat_finetune_resnet(
        export_inference_params(pst), x[:64], y[:64], epochs=1,
        batch_size=TRAIN_BATCH, lr=1e-4, small_input=False,
        mask_fn=mask_fn, calib_x=x[:16], calib_batch_size=16, device=dev)
    masked_zero(flat_q, "QAT")
    for k in s0:
        if not np.array_equal(flat_q[k], pst.bn_state[k]):
            fail(f"QAT moved the frozen running statistic {k}")
    print(f"pruned at 0.7 (normalized, by parameters) over {len(cfgs)} "
          f"convs, 2 masked steps with the group lasso and 2 QAT steps: "
          f"every pruned weight 0, the running statistics frozen by QAT")

    # 30.3 serving the trained, pruned, QAT'd ResNet-18 through K1-K4
    model = quantize_resnet18(flat_q, x[:16], CLASSES)
    sparse = attach_bsr(model, block=BLOCK, min_sparsity=0.25)
    n_bsr = sum(qc.bsr is not None for _, qc in sparse.named_convs())
    xb = np.ascontiguousarray(x[:BATCH])
    seng = InferenceEngine(sparse, device=dev)
    sres, counts = served_launches(
        _kernels, lambda: seng.run_inference(xb),
        ["stem_fused", "conv_int8", "matmul_int8", "bsr_matmul"],
        f"the trained ResNet-18, {n_bsr} BSR convs, a batch of {BATCH}",
        {"bsr_matmul": "wgmma_tma", "matmul_int8": "wgmma_tma",
         "conv_int8": "wgmma_tma"})
    add(counts)
    with torch.inference_mode():
        xt = torch.from_numpy(xb).to(dev)
        plain = seng.module.forward_plain(xt).cpu().numpy()
        dense = InferenceEngine(model, device=dev).module(xt).cpu().numpy()
    if sres.logits.shape != (BATCH, CLASSES) or \
            not np.isfinite(sres.logits).all():
        fail(f"trained ResNet-18 logits {sres.logits.shape} not finite")
    if not (np.array_equal(sres.logits, plain)
            and np.array_equal(sres.logits, dense)):
        fail("trained ResNet-18: logits differ from the plain path or the "
             "dense serving")
    acc = float((sres.predictions == y[:BATCH]).mean())
    report = {k: round(v, 2) for k, v in sparse.sparsity_report().items()}
    print(f"trained ResNet-18 served: [{BATCH}, {CLASSES}] logits "
          f"bit-identical to the plain path and to the dense serving of the "
          f"same model; block sparsity {report}; int8 accuracy on its "
          f"training images {acc:.4f}")
    del seng

    # 30.4 the serving LM trained on the cyclic language, pruned, served
    cfg = {k: LM_CFG[k] for k in ("vocab", "d_model", "n_heads", "d_ff",
                                  "n_layers", "max_len")}
    V, L, H = cfg["vocab"], cfg["n_layers"], cfg["n_heads"]
    lp0 = init_lm_fp32(**cfg, seed=SEED)
    (lp, hist), dt = cuda_timed(lambda: train_lm(lp0,
        L, H, V, seq_len=LM_TRAIN["seq_len"], steps=LM_TRAIN["steps"],
        batch=LM_TRAIN["batch"], seed=SEED, device=dev))
    first, last = float(np.mean(hist[:20])), float(np.mean(hist[-20:]))
    n_tok = LM_TRAIN["steps"] * LM_TRAIN["batch"] * LM_TRAIN["seq_len"]
    print(f"train_lm, {LM_TRAIN['steps']} steps of {LM_TRAIN['batch']} x "
          f"{LM_TRAIN['seq_len']} tokens: loss {first:.4f} (first 20) -> "
          f"{last:.4f} (last 20); {n_tok / dt:.1f} tokens/s, "
          f"{dt / LM_TRAIN['steps'] * 1e3:.2f} ms a step (CUDA events over "
          f"the call, its first step included)  ({label})")
    if not last < 0.5 * first:
        fail(f"LM training: the last 20 losses' mean {last} is not below "
             f"half the first 20's {first}")
    profiled(f"train_lm, 5 steps of {LM_TRAIN['batch']} x "
             f"{LM_TRAIN['seq_len']}", lambda: train_lm(
                 lp0, L, H, V, seq_len=LM_TRAIN["seq_len"], steps=5,
                 batch=LM_TRAIN["batch"], seed=SEED, device=dev), label)
    seq = cyclic_sequences(V, LM_TRAIN["seq_len"], 8, seed=SEED + 43)
    with torch.no_grad():
        tl = {k: torch.from_numpy(np.asarray(v)).to(dev)
              for k, v in lp.items() if k != "meta"}
        pred = lm_forward_fp32(tl, torch.from_numpy(seq).to(dev).long(), L,
                               H).argmax(-1).cpu().numpy()
    print(f"trained LM, float32: next-token accuracy "
          f"{float((pred[:, :-1] == seq[:, 1:]).mean()):.4f} on 8 unseen "
          f"sequences of the trained length {LM_TRAIN['seq_len']}")
    lm = quantize_lm(prune_lm_blockwise(lp, LM_CFG["sparsity"],
                                        LM_CFG["block"]), H,
                     LM_CFG["block"])
    prompt = cyclic_sequences(V, PROMPT, 1, seed=SEED + 41)[0]
    scales = lm.calibrate(prompt[:64])
    lmod = lm.module(dev)
    toks, counts = served_launches(
        _kernels, lambda: lmod.generate(prompt, 64, scales, flash=True),
        ["flash_attention"], f"the trained LM, generate(flash=True) "
        f"{PROMPT} -> 64")
    add(counts)
    if counts["flash_attention"] != L:
        fail(f"trained LM: flash_attention launched "
             f"{counts['flash_attention']} times, not {L}")
    plain = lmod.generate(prompt, 64, scales, flash=True, plain=True)
    if toks.shape != (64,) or not np.array_equal(toks, plain):
        fail("trained LM: tokens differ from the plain path on the card")
    want = (3 * np.concatenate([prompt[-1:], toks[:-1]]) + 1) % V
    print(f"trained LM (sparsity {lm.blocks[0].sparsity_report()['wq']:.2f}"
          f" a projection): 64 tokens equal the plain path's; "
          f"{float((toks == want).mean()):.4f} follow the affine rule (its "
          f"positions past {LM_TRAIN['seq_len']} never trained)")

    # 30.5 MNIST through the CLI: train --prune, quantize, infer; then QAT
    # on the pruned checkpoint, served with fc1 through K4
    tmp = tempfile.TemporaryDirectory()
    raw = os.path.join(tmp.name, "raw")
    save_idx_split(raw, *synthetic_digits(MNIST_TRAIN_N, seed=SEED + 42))
    ck = os.path.join(tmp.name, "ck.npz")
    q = os.path.join(tmp.name, "int8")
    imgs, labels = load_mnist_split(raw)
    np.save(os.path.join(tmp.name, "x.npy"), imgs[:8])
    for args, expect in (
            (["train", "--data", raw, "--epochs", "1", "--prune",
              "--schedule", "0.5,0.7", "--output", ck, "--device",
              dev.type],
             "final block sparsity"),
            (["quantize", "--checkpoint", ck, "--output", q], "quantized"),
            (["infer", "--model", "mnist", "--weights", q, "--input",
              os.path.join(tmp.name, "x.npy"), "--device", dev.type],
             "sample 7")):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "resnet_accel_tpu_torch", *args],
            cwd=repo, capture_output=True, text=True, timeout=300)
        print("\n".join(ln[:160] for ln in proc.stdout.splitlines()))
        print(f"{args[0]}: {time.perf_counter() - t0:.1f} s  ({label})")
        if proc.returncode != 0 or expect not in proc.stdout:
            print(proc.stderr, file=sys.stderr)
            fail(f"CLI {args[0]} exited {proc.returncode}")
    params = load_checkpoint(ck)
    fc1 = params["fc1.weight"]
    keep = np.abs(fc1).reshape(128, 72, 128).sum(axis=(0, 2))[None] != 0
    fcfg = {"fc1.weight": BlockCfg(128, 128, 0.05)}
    qat = qat_finetune(imgs, labels, params=params, epochs=1, seed=SEED,
                       mask_fn=make_mask_fn({"fc1.weight": keep}, fcfg,
                                            {"fc1.weight": fc1.shape}),
                       device=dev)
    if not np.all(qat.params["fc1.weight"][:, ~np.repeat(keep[0], 128)]
                  == 0):
        fail("QAT moved fc1's pruned blocks")
    mnist = export_qat(qat).with_fc1_bsr(BLOCK)
    xm = preprocess_mnist(imgs[:BATCH])
    meng = InferenceEngine(mnist, device=dev)
    mres, counts = served_launches(
        _kernels, lambda: meng.run_inference(xm),
        ["conv_int8", "matmul_int8", "bsr_matmul"],
        f"the QAT'd MNIST CNN, fc1 {mnist.sparsity_report()}, a batch of "
        f"{BATCH}", {"bsr_matmul": "wgmma_tma", "matmul_int8": "wgmma_tma"})
    add(counts)
    with torch.inference_mode():
        plain = meng.module.forward_plain(
            torch.from_numpy(xm).to(dev)).cpu().numpy()
    if not np.array_equal(mres.logits, plain):
        fail("QAT'd MNIST CNN: logits differ from the plain path")
    acc = float((mres.predictions == labels[:BATCH]).mean())
    print(f"QAT'd MNIST CNN served: {1 - keep.mean():.2f} of fc1's blocks "
          f"zero through QAT, logits bit-identical to the plain path, int8 "
          f"accuracy {acc:.4f} on {BATCH} training digits, QAT loss "
          f"{qat.history[-1]['loss']:.4f}")
    mgr = CheckpointManager(os.path.join(tmp.name, "steps"), max_to_keep=2)
    for step in (1, 2, 3):
        mgr.save(step, qat.params)
    if mgr.latest_step() != 3 or len(os.listdir(mgr.directory)) != 2:
        fail("CheckpointManager did not keep the newest two")
    tmp.cleanup()
    print(f"phase 30 (training on the card): {time.perf_counter() - t30:.1f}"
          f" s")
    return launches


#: Phase 31: the ranks of one world share the card over gloo.
PAR_WORLD = 4
#: The dp BSR GEMM at the bench sweep's size: M rows split over the ranks.
PAR_GEMM = dict(M=512, N=2048, K=2048, block=128, sparsity=0.9)


def parallel_phase(dev, label, _kernels, model, sparse, xb, logits,
                   slogits, lm, lm_scales, lm_args, prompts, ref,
                   nccl: bool = True) -> dict:
    """Phase 31: the parallel programs in spawned ranks sharing the card.
    Returns the launch counts of the data-parallel served paths, summed
    over the ranks."""
    import contextlib as _ctx
    from resnet_accel_tpu_torch import cli
    from resnet_accel_tpu_torch.golden import bsr_matmul_int8_wt
    from resnet_accel_tpu_torch.models.moe import MoEBlockInt8
    from resnet_accel_tpu_torch.models.transformer import \
        TransformerBlockInt8Module
    from resnet_accel_tpu_torch.ops import bsr_matmul_wt, pack_bsr
    from resnet_accel_tpu_torch.parallel import jobs
    from resnet_accel_tpu_torch.parallel.dryrun import _dryrun_body
    from resnet_accel_tpu_torch.parallel.launch import run_world
    from resnet_accel_tpu_torch.runtime import PagedKVBatcher
    from resnet_accel_tpu_torch.sparse import build_bsr_int8_direct
    from resnet_accel_tpu_torch.train.mnist import (init_mnist_params,
                                                    mnist_forward_fp32)
    t31 = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    n_new = ref.shape[1]
    n_req, T = prompts.shape
    rng = np.random.default_rng(SEED + 31)

    # the references, in this process: the dp GEMM's golden and K4 on one
    # rank; the int8 paged engine on one rank; the sp block, the MoE and
    # the MNIST CNN unsharded
    g = PAR_GEMM
    W = rng.integers(-128, 128, (g["N"], g["K"])).astype(np.int8)
    nb = -(-g["N"] // g["block"])
    keep = np.repeat(np.repeat(rng.random((nb, nb)) >= g["sparsity"],
                               g["block"], 0), g["block"], 1)
    bsr = build_bsr_int8_direct(W * keep[:g["N"], :g["K"]], g["block"])
    A = rng.integers(-128, 128, (g["M"], g["K"])).astype(np.int8)
    gemm_golden = bsr_matmul_int8_wt(A, bsr.data, bsr.row_ptr, bsr.col_idx,
                                     g["block"], g["block"], N=g["N"])
    with torch.inference_mode():
        gemm_one = bsr_matmul_wt(torch.from_numpy(A).to(dev),
                                 pack_bsr(bsr, dev)).cpu().numpy()
    if not np.array_equal(gemm_one, gemm_golden):
        fail("K4 on one rank differs from the golden at the dp GEMM")
    pool = 1 + n_req * -(-(T + n_new + 7) // 16)
    engine = dict(slots=n_req, page=16, pool_pages=pool, spec_draft=7)
    reqs = [[(p.tolist(), n_new, 0) for p in prompts]]
    eng = PagedKVBatcher(lm, lm_scales, kv_dtype="int8", device=dev,
                         **engine)
    rids = [eng.submit(p, n, seed=sd) for p, n, sd in reqs[0]]
    res = eng.run()
    int8_ref = [res[r] for r in rids]
    block = lm.blocks[0]
    sp_x = rng.normal(0, 1, (T, block.d_model)).astype(np.float32)
    moe = MoEBlockInt8.from_random(n_experts=4, seed=SEED)
    ep_x = rng.normal(0, 1, (T, 128)).astype(np.float32)
    mn = init_mnist_params(seed=SEED)
    c_x = rng.normal(0, 1, (8, 1, 28, 28)).astype(np.float32)
    c_y = rng.integers(0, 10, 8).astype(np.int32)
    with torch.inference_mode():
        sp_ref = TransformerBlockInt8Module(block, dev)(
            torch.from_numpy(sp_x).to(dev)).cpu().numpy()
        ep_ref = moe.module(dev)(ep_x).cpu().numpy()
        p_dev = {k: torch.from_numpy(v).to(dev) for k, v in mn.items()}
        c_ref = mnist_forward_fp32(p_dev, torch.from_numpy(c_x).to(
            dev)).cpu()
        c_loss = float(torch.nn.functional.cross_entropy(
            c_ref, torch.from_numpy(c_y).long()))
        c_ref = c_ref.numpy()
    print(f"phase 31 references on one rank: {time.perf_counter() - t31:.1f}"
          f" s")

    # ---- 31.1 one world of PAR_WORLD ranks sharing the card, over gloo
    cube = {"dp": 1, "pp": 2, "tp": 2}
    job_list = [
        ("world", jobs.world_info, ()),
        ("dp_resnet", jobs.dp_forward, (model, xb, None, 5)),
        ("dp_sparse", jobs.dp_forward, (sparse, xb)),
        ("dp_bsr", jobs.dp_bsr, (bsr, A)),
        ("paged_int8", jobs.paged_tp, ({"dp": 2, "tp": 2}, lm, lm_scales,
                                       reqs, {**engine, "kv_dtype": "int8"})),
        ("gen_batched", jobs.tp_generate, ({"dp": 2, "tp": 2}, lm,
                                           lm_scales, prompts[:4], n_new,
                                           True)),
        ("sp", jobs.sp_forward, ({"sp": PAR_WORLD}, block, sp_x)),
        ("ep", jobs.ep_forward, ({"ep": PAR_WORLD}, moe, ep_x)),
        ("pp", jobs.pipeline_forward, (cube, "mnist", mn, 2, 4, c_x)),
        ("combined", jobs.combined_forward, (cube, mn, c_x)),
        ("combined_step", jobs.combined_train, (cube, mn, c_x, c_y, 1)),
        ("dryrun", _dryrun_body, ()),
    ]
    t0 = time.perf_counter()
    ranks = run_world(jobs.run_jobs, PAR_WORLD, device=dev, backend="gloo",
                      args=(dev.type, job_list), timeout_s=600)
    print(f"world of {PAR_WORLD} ranks: {time.perf_counter() - t0:.1f} s, "
          f"spawn and every job included; each job's seconds on rank 0: "
          + ", ".join(f"{k} {v:.2f}" for k, v in ranks[0]["seconds"].items()))
    infos = [r["world"] for r in ranks]
    print(f"world: {[(i['rank'], i['backend'], i['device']) for i in infos]}")
    if {i["backend"] for i in infos} != {"gloo"} or \
            {i["device"] for i in infos} != {str(dev)}:
        fail(f"the world's ranks are not gloo on {dev}: {infos}")

    def agreed(key):
        vals = [r[key] for r in ranks if r[key] is not None]
        for v in vals[1:]:
            for a, b in zip(_leaves(v), _leaves(vals[0])):
                if not np.array_equal(np.asarray(a), np.asarray(b)):
                    fail(f"{key}: the ranks disagree")
        return vals[0]

    launches = dict.fromkeys(_kernels.KERNELS, 0)
    for key, want, must in (
            ("dp_resnet", logits, ("stem_fused", "conv_int8", "matmul_int8")),
            ("dp_sparse", slogits, ("stem_fused", "conv_int8", "matmul_int8",
                                    "bsr_matmul")),
            ("dp_bsr", gemm_golden, ("bsr_matmul",))):
        out = agreed(key)
        got = out["logits"] if "logits" in out else out["out"]
        if got.shape != want.shape or not np.array_equal(got, want):
            fail(f"{key}: differs from the single-rank port "
                 f"{'and the golden ' if key == 'dp_bsr' else ''}"
                 f"(max |err| {np.abs(got.astype(np.float64) - want).max()})")
        for r, res in enumerate(ranks):
            counts = res[key]["counts"]
            if counts is None:          # the CPU's plain versions count none
                if dev.type == "cuda":
                    fail(f"{key}: rank {r} returned no launch counts")
                continue
            for k in must:
                if counts["launches"][k] == 0:
                    fail(f"{key}: {k} never launched in rank {r}")
            for k, n in counts["launches"].items():
                launches[k] += n
        print(f"{key}: {got.shape} bit-identical to the single-rank port"
              f"{' and the golden' if key == 'dp_bsr' else ''}; launches by "
              f"rank: {[(res[key]['counts'] or {}).get('launches') for res in ranks]}")
    d = agreed("dp_resnet")
    if "ms_rank" in d:
        print(f"dp ResNet-18, batch {len(xb)} over {PAR_WORLD} ranks on one "
              f"card: {d['rows']} images a rank, the rank's forward "
              f"{d['ms_rank']:.3f} ms (median, CUDA events; ranks "
              f"{[round(r['dp_resnet']['ms_rank'], 3) for r in ranks]}), "
              f"the whole program with its all-gather {d['ms_whole']:.3f} ms"
              f" (host clock); {PAR_WORLD} ranks sharing one card over gloo,"
              f" not scaling  ({label})")

    p8 = agreed("paged_int8")
    if p8["streams"][0] != int8_ref:
        fail("tp 2 int8-KV paged streams differ from the single-rank int8 "
             "engine's")
    n_tok = sum(map(len, int8_ref))
    print(f"PagedKVBatcher(tp_mesh=dp2 x tp2), int8 KV, spec_draft 7: "
          f"{n_req} requests, {T} -> {n_new}: streams equal the single-rank "
          f"int8 engine's; rank-local pool {p8['slice']}, {n_tok} tokens, "
          f"{n_tok / p8['seconds']:.1f} tokens/s (host clock; 4 ranks "
          f"sharing one card over gloo)  ({label})")
    got = agreed("gen_batched")
    if not np.array_equal(got, ref[:4]):
        fail("make_tp_lm_generate(batched) on dp 2 x tp 2: tokens differ "
             "from generate(parallel_prefill=False)'s")
    sec = ranks[0]["seconds"]["gen_batched"]
    print(f"make_tp_lm_generate(batched=True) on dp 2 x tp 2, {T} -> "
          f"{n_new}: tokens {got.shape} equal generate(parallel_prefill="
          f"False)'s; {got.size / sec:.1f} tokens/s (host clock, setup "
          f"included; {PAR_WORLD} ranks sharing one card over gloo)  "
          f"({label})")
    for key, want, tol in (("sp", sp_ref, 2e-3), ("ep", ep_ref, 0.0),
                           ("pp", c_ref, 1e-4), ("combined", c_ref, 1e-4)):
        got = agreed(key)
        err = max_abs_err(torch.from_numpy(np.asarray(got)),
                          torch.from_numpy(want))
        if got.shape != want.shape or not err <= tol:
            fail(f"{key}: off the single-rank forward by {err} (> {tol})")
        print(f"{key}: {got.shape}, max |err| vs the single-rank forward "
              f"{err:.3g} (within {tol}); {ranks[0]['seconds'][key]:.2f} s "
              f"(host clock)")
    step = agreed("combined_step")
    if not abs(step["losses"][0] - c_loss) <= 1e-5 * abs(c_loss):
        fail(f"combined Adam step: loss {step['losses'][0]} vs the "
             f"unsharded {c_loss}")
    print(f"combined dp1 x pp2 x tp2 Adam step: loss {step['losses'][0]:.6f}"
          f" (unsharded {c_loss:.6f})")
    print(agreed("dryrun"))

    # ---- 31.2 the NCCL build: a world of one rank, tp 1 paged programs
    if nccl:
        t0 = time.perf_counter()
        one = run_world(jobs.run_jobs, 1, device=dev, backend="nccl",
                        args=(dev.type, [
                            ("world", jobs.world_info, ()),
                            ("paged", jobs.paged_tp, ({"tp": 1}, lm,
                                                      lm_scales, reqs,
                                                      engine))]),
                        timeout_s=300)[0]
        if one["world"]["backend"] != "nccl" or \
                one["paged"]["streams"][0] != [r.tolist() for r in
                                               ref[:n_req]]:
            fail(f"the NCCL world: {one['world']}, streams differ from "
                 "generate's")
        print(f"NCCL world of 1 rank ({one['world']}): tp 1 paged engine, "
              f"spec_draft 7, streams equal generate's; "
              f"{time.perf_counter() - t0:.1f} s")

    # ---- 31.3 serve --tp 2 (a world of its own), and its refusal over
    # NCCL with fewer cards than ranks
    args = ["serve", "--prompts", ";".join(",".join(map(str, p.tolist()))
                                          for p in prompts),
            "--n-new", str(n_new), "--slots", str(n_req), "--page", "16",
            "--pool-pages", str(pool), "--spec-draft", "7", "--tp", "2",
            *lm_args]
    if dev.type == "cuda" and torch.cuda.device_count() < 2:
        try:
            cli.main(args)
        except SystemExit as e:
            if str(e) != "--tp 2 needs 2 devices, have 1":
                fail(f"serve --tp 2 over nccl: {e}")
            print(f"serve --tp 2 over nccl on one card refused: {e}")
        else:
            fail("serve --tp 2 over nccl ran on one card")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with _ctx.redirect_stdout(buf):
        rc = cli.main(args + ["--dist-backend", "gloo"])
    out = buf.getvalue().splitlines()
    print("\n".join(ln[:160] for ln in out))
    want = [f"-> {r.tolist()}" for r in ref[:n_req]]
    reqs_out = [ln for ln in out if ln.startswith("req ")]
    if rc != 0 or len(reqs_out) != n_req or not all(
            ln.endswith(w) for ln, w in zip(reqs_out, want)) or \
            not out[-1].endswith("tp=2 (KV sliced by head)"):
        fail("serve --tp 2: streams differ from the single-rank engine's")
    print(f"serve --tp 2 over gloo: {n_req} streams equal the single-rank "
          f"PagedKVBatcher's; {time.perf_counter() - t0:.1f} s, spawn "
          f"included  ({label})")
    print(f"phase 31 launches, summed over the ranks (K1-K4): "
          f"{ {k: launches[k] for k in ('stem_fused', 'conv_int8', 'matmul_int8', 'bsr_matmul')} }")
    print(f"phase 31 (parallelism, ranks sharing the card): "
          f"{time.perf_counter() - t31:.1f} s")
    return launches


def _leaves(v):
    """The arrays and scalars of a job's result, flattened (host times
    left out: each rank has its own)."""
    if isinstance(v, dict):
        return [x for k in sorted(v) if k not in ("seconds", "ms_rank",
                                                 "ms_whole")
                for x in _leaves(v[k])]
    if isinstance(v, (list, tuple)):
        return [x for e in v for x in _leaves(e)]
    return [v]


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs a card")
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "resnet_accel_tpu_torch")):
        fail(f"no resnet_accel_tpu_torch package beside {__file__}")
    sys.path.insert(0, repo)
    from resnet_accel_tpu_torch import _kernels, cli, probes
    from resnet_accel_tpu_torch.models.lm import TransformerLMInt8
    from resnet_accel_tpu_torch.models.mnist_cnn import (
        MNISTCNNInt8, MNISTCNNInt8Module)
    from resnet_accel_tpu_torch.models.resnet import (init_resnet_fp32,
                                                      quantize_resnet,
                                                      trunk_convs)
    from resnet_accel_tpu_torch.models.resnet18 import (
        ResNet18Int8Module, attach_bsr, init_resnet18_fp32,
        prune_params_blockwise, quantize_resnet18)
    from resnet_accel_tpu_torch.ops import (
        add_residual, avgpool_global_int8, bsr_matmul_wt, bsr_matmul_wt_plain,
        conv2d_int8, conv2d_int8_plain, expand_add_int8,
        expand_add_int8_plain, expand_plan, flash_attention,
        flash_attention_plain,
        bsr_plan, im2col_nchw, matmul_int8, matmul_int8_plain, matmul_plan,
        maxpool2d_int8, pack_bsr, pack_stem_weight, pack_weight,
        quantize_input, quantize_s2d,
        quantize_s2d_nchw, sparse_conv2d_int8, sparse_conv2d_int8_plain,
        sparse_conv_plan,
        stem_conv_pool, stem_conv_pool_int8, stem_conv_pool_int8_plain,
        stem_conv_pool_plain, stem_s2d_weights)
    from resnet_accel_tpu_torch import native
    from resnet_accel_tpu_torch.runtime import power, xprof
    from resnet_accel_tpu_torch.runtime.engine import (
        IMAGENET_MEAN, IMAGENET_STD, AccelErrorCode, AcceleratorError,
        InferenceEngine, QuantizingLoader, preprocess_imagenet,
        preprocess_mnist)
    from resnet_accel_tpu_torch.runtime.profile import profile_resnet18
    from resnet_accel_tpu_torch.sparse import (device_pack, pack_conv_bsr,
                                               tap_sparse_weight)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    cl = torch.channels_last
    label = cli.device_label(dev)
    n_sms = _kernels.sm_count(dev)
    print(label)  # name, power limit: as nvidia-smi prints them
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t_start = time.perf_counter()
    # before any load: the idle reading beside the power limit (phase 26)
    telemetry = power.probe_live_telemetry(dev.index)
    print(f"telemetry before any load: {telemetry}")

    # ---- 1. build ----------------------------------------------------
    t0 = time.perf_counter()
    _kernels.build(verbose=True)
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")

    # ---- model and inputs (seeded, calibrated on the CPU) -------------
    rng = np.random.default_rng(SEED)
    calib = rng.normal(0, 1, (2, 3, HW, HW)).astype(np.float32)
    t0 = time.perf_counter()
    params = init_resnet18_fp32(seed=SEED, num_classes=CLASSES)
    model = quantize_resnet18(params, calib, CLASSES)
    print(f"quantize + calibrate on the CPU: "
          f"{time.perf_counter() - t0:.1f} s")
    batches = [rng.normal(0, 1, (BATCH, 3, HW, HW)).astype(np.float32)
               for _ in range(3)]
    mod = ResNet18Int8Module(model, dev).eval()
    x = torch.from_numpy(batches[0]).to(dev)

    # ---- 2. each kernel against its plain version ---------------------
    stats = {k: {"ms": 0.0, "plain_ms": 0.0, "err": 0.0, "bytes_ms": 0.0,
                 "ops_ms": 0.0, "bound_ms": 0.0, "library_ms": None}
             for k in _kernels.KERNELS}
    last_check = {}     # the times of the last check()

    def check(kernel, name, fn, plain, shape, work, library=None, iters=10,
              plain_iters=3, timed=True, tol=0.0, plan=None):
        """Kernel vs plain: bit for bit, or within rtol = atol = ``tol``.
        ``work(out)`` gives (bytes, operations, their type) of one call,
        for the bound; ``library`` is one PyTorch call computing the same
        function, timed beside the kernel.  With ``timed`` the times and
        bounds add to the kernel's totals.  ``plan``: K3's or K4's path,
        printed beside the time."""
        got, want = fn(), plain()
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        s = stats[kernel]
        s["err"] = max(s["err"], err)
        ms, pms = time_ms(fn, iters), time_ms(plain, plain_iters)
        b_ms, o_ms = bound_ms(*work(want))
        lib = ""
        lms = None
        if library is not None:
            try:
                lms = time_ms(library, iters)
                lib = f"  library {lms:.4f} ms"
            except RuntimeError as e:   # a shape the library refuses
                lib = f"  library refused: {str(e).splitlines()[0]}"
        last_check.update(ms=ms, plain_ms=pms, bound_ms=max(b_ms, o_ms),
                          library_ms=lms, out=got)
        if timed:
            s["ms"] += ms
            s["plain_ms"] += pms
            s["bytes_ms"] += b_ms
            s["ops_ms"] += o_ms
            s["bound_ms"] += max(b_ms, o_ms)
            if lms is not None:
                s["library_ms"] = (s["library_ms"] or 0.0) + lms
        ok = (got.shape == want.shape and got.dtype == want.dtype and
              (torch.equal(got, want) if tol == 0.0 else
               torch.allclose(got, want, rtol=tol, atol=tol)))
        print(f"{kernel:12s} {name:6s} {shape:42s} "
              f"{'equal' if tol == 0.0 else f'within {tol:g}'}={ok} "
              f"(max |err| {err:.3g}) kernel {ms:.4f} ms"
              f"{' ' + plan_text(plan) if plan else ''}  plain {pms:.4f} ms"
              f"  bound {max(b_ms, o_ms):.4f} ms{lib}  ({label})")
        if not ok:
            fail(f"{kernel} {name}: kernel != plain (max |err| {err})")
        return want

    def summary(title, before, names):
        """Each kernel's totals since ``before`` (a copy of ``stats``)."""
        def d(k, f):
            return (stats[k][f] or 0.0) - (before[k][f] or 0.0)
        print(f"{title}, summed: " + "; ".join(
            f"{k} {d(k, 'ms'):.4f} ms (plain {d(k, 'plain_ms'):.4f}, "
            f"bound {d(k, 'bound_ms'):.4f}"
            + (f", library {d(k, 'library_ms'):.4f}"
               if stats[k]["library_ms"] is not None else "") + ")"
            for k in names) + f"  ({label})")

    def stem_case(m):
        st = m.stem
        N, _, H, W = x.shape
        Hc, Wc = (H - 1) // 2 + 1, (W - 1) // 2 + 1   # the 7x7/s2/p3 conv

        def work(out):
            return (x.numel() * 4 + st.weight.numel() + 8 * 64 + out.numel(),
                    2 * N * 64 * Hc * Wc * st.weight[0].numel(), "int8")
        return check("stem_fused", "stem",
                     lambda: stem_conv_pool(x, m.stem_k1_w, st.bias,
                                            st.factors, m.s_input),
                     lambda: stem_conv_pool_plain(x, st.weight, st.bias,
                                                  st.factors, m.s_input),
                     f"x{list(x.shape)} fp32", work)

    k2_stages = {}      # (depth, stage): [K2 ms, bound ms, convs]

    def conv_case(depth, name, cv, inp, **join):
        shape = (f"x{list(inp.shape)} k{cv.weight.shape[-1]} "
                 f"s{cv.stride} O{cv.weight.shape[0]}"
                 + (" +join" if join else ""))

        def work(out):
            res = join["residual"].numel() if join else 0
            return (inp.numel() + cv.weight.numel() + 8 * out.shape[1]
                    + res + out.numel(),
                    2 * out.numel() * cv.weight[0].numel(), "int8")
        out = check("conv_int8", name,
                    lambda: cv(inp, conv2d_int8, **join),
                    lambda: cv(inp, conv2d_int8_plain, **join), shape, work)
        st = k2_stages.setdefault((depth, stage_of[depth][name]), [0, 0, 0])
        st[0] += last_check["ms"]
        st[1] += last_check["bound_ms"]
        st[2] += 1
        return out

    stage_of = {d: {c.name: c.stage for c in trunk_convs(d)}
                for d in (18, 50)}

    def k2_stage_lines(depth):
        for (d, stage), (ms, bnd, n) in sorted(k2_stages.items()):
            if d == depth:
                print(f"K2 ResNet-{depth} stage {stage} ({n} convs): "
                      f"{ms:.4f} ms, bound {bnd:.4f} ms ({ms / bnd:.1f}x)"
                      f"  ({label})")

    def fc_case(m, a):
        p = avgpool_global_int8(a)
        (M, K), N = p.shape, m.fc_w.shape[1]
        mm = int_mm_call(p, m.fc_w.t())

        def work(out):
            return M * K + K * N + 4 * N + 4 * M * N, 2 * M * K * N, "int8"
        return check("matmul_int8", "fc",
                     lambda: matmul_int8(p, m.fc_w, bias=m.fc_b),
                     lambda: matmul_int8_plain(p, m.fc_w, bias=m.fc_b),
                     f"a{list(p.shape)} b{list(m.fc_w.shape)} int32", work,
                     library=None if mm is None else lambda: mm() + m.fc_b,
                     plan=matmul_plan(p, m.fc_w.t(), n_sms))

    k2_before = dict(_kernels.KERNELS["conv_int8"].variants)
    with torch.inference_mode():
        a = stem_case(mod)
        for i, (convs, rs) in enumerate(zip(mod.blocks, mod.res_scales)):
            y = conv_case(18, f"b{i}.c1", convs["c1"], a)
            r = (conv_case(18, f"b{i}.ds", convs["ds"], a) if "ds" in convs
                 else a)
            a = conv_case(18, f"b{i}.c2", convs["c2"], y, residual=r,
                          res_scales=rs)
        fc_case(mod, a)
    summary("ResNet-18 walk", {k: dict.fromkeys(v, 0.0)
                               for k, v in stats.items()},
            ("stem_fused", "conv_int8", "matmul_int8"))
    paths_since(_kernels, "conv_int8", k2_before, "wgmma_tma",
                "the ResNet-18 walk")
    k2_stage_lines(18)

    # ---- 3. the dense slice through the engine ------------------------
    engine = InferenceEngine(model, device="cuda")
    results, launches = served_launches(
        _kernels, lambda: [engine.run_inference(xb) for xb in batches],
        ["stem_fused", "conv_int8", "matmul_int8"],
        f"dense ResNet-18, {len(batches)} batches of {BATCH}",
        {"matmul_int8": "wgmma_tma",
         "conv_int8": {"wgmma_tma": 19 * len(batches)}})
    with torch.inference_mode():
        for b, (xb, res) in enumerate(zip(batches, results)):
            if res.logits.shape != (BATCH, CLASSES) or \
                    not np.isfinite(res.logits).all():
                fail(f"batch {b}: logits {res.logits.shape} not finite "
                     f"[{BATCH}, {CLASSES}]")
            plain = engine.module.forward_plain(
                torch.from_numpy(xb).to(dev)).cpu().numpy()
            if not np.array_equal(res.logits, plain):
                fail(f"batch {b}: logits differ from the plain path "
                     f"(max |err| {np.abs(res.logits - plain).max()})")
        cpu = ResNet18Int8Module(model, "cpu")(
            torch.from_numpy(batches[0][:2])).numpy()
    if not np.array_equal(results[0].logits[:2], cpu):
        fail("logits differ from the plain path on the CPU")
    print(f"logits: {len(batches)} x [{BATCH}, {CLASSES}] finite, "
          f"bit-identical to the plain path on the card and (2 images) "
          f"on the CPU; top-1 of batch 0: {results[0].predictions[:8]}")
    bench = engine.benchmark(batches[0], iters=10)
    print(f"forward batch {BATCH}: {bench.latency_s * 1e3:.3f} ms median, "
          f"{bench.images_per_s:.1f} img/s; run_inference incl. copies: "
          f"{[round(r.images_per_s, 1) for r in results]} img/s  "
          f"({label})")
    del engine

    # ---- 4. the CLI: ResNet-18 and ResNet-50 ----------------------------
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "x.npy")
        np.save(path, np.random.default_rng(1).normal(
            0, 1, (4, 3, HW, HW)).astype(np.float32))
        for model_args in (["resnet18"], ["resnet", "--depth", "50"]):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "resnet_accel_tpu_torch", "infer",
                 "--model", *model_args, "--input", path, "--device",
                 "cuda", "--limit", "4"], cwd=repo, capture_output=True,
                text=True, timeout=600)
            print(proc.stdout, end="")
            print(f"infer --model {' '.join(model_args)}: "
                  f"{time.perf_counter() - t0:.1f} s  ({label})")
            if proc.returncode != 0 or "sample 3:" not in proc.stdout:
                print(proc.stderr, file=sys.stderr)
                fail(f"CLI infer --model {' '.join(model_args)} exited "
                     f"{proc.returncode}")

    # ---- 5. ResNet-50: K7 at every c3 ---------------------------------
    t0 = time.perf_counter()
    model50 = quantize_resnet(init_resnet_fp32(50, seed=SEED,
                                               num_classes=CLASSES),
                              calib, 50, CLASSES)
    print(f"ResNet-50 init + quantize + calibrate on the CPU: "
          f"{time.perf_counter() - t0:.1f} s")
    mod50 = ResNet18Int8Module(model50, dev).eval()
    before = {k: dict(v) for k, v in stats.items()}
    k7_stages = {}      # stage: [K7 ms, bound ms, _int_mm ms, K2 ms, c3s]
    k2_before = dict(_kernels.KERNELS["conv_int8"].variants)
    with torch.inference_mode():
        a = stem_case(mod50)
        for i, (convs, rs, inv) in enumerate(zip(
                mod50.blocks, mod50.res_scales, mod50.inv_out)):
            y = conv_case(50, f"b{i}.c1", convs["c1"], a)
            r = (conv_case(50, f"b{i}.ds", convs["ds"], a) if "ds" in convs
                 else a)
            y = conv_case(50, f"b{i}.c2", convs["c2"], y)
            c3 = convs["c3"]
            args = (y, c3.weight.reshape(c3.weight.shape[0], -1), c3.bias,
                    c3.factors, r, *rs)

            def work(out):
                O, C = args[1].shape
                return (y.numel() + O * C + 8 * O + r.numel() + out.numel(),
                        2 * out.numel() * C, "int8")
            # the library: the c3's product alone, [N*H*W, C] x [C, 4C]
            y2d = y.permute(0, 2, 3, 1).reshape(-1, y.shape[1])
            k7_before = dict(_kernels.KERNELS["expand_add"].variants)
            # as served: joined by the block's proven reciprocal, if any
            a = check("expand_add", f"b{i}.c3",
                      lambda: expand_add_int8(*args, inv_out=inv),
                      lambda: expand_add_int8_plain(*args, inv_out=inv),
                      f"x{list(y.shape)} O{c3.weight.shape[0]} +join"
                      + (" inv" if inv is not None else " div"), work,
                      library=int_mm_call(y2d, args[1]),
                      plan=expand_plan(*args[:5]))
            k7 = last_check["ms"], last_check["bound_ms"], \
                last_check["library_ms"] or 0.0
            if inv is not None:     # and by the divide, untimed
                check("expand_add", f"b{i}.c3",
                      lambda: expand_add_int8(*args),
                      lambda: expand_add_int8_plain(*args),
                      f"x{list(y.shape)} O{c3.weight.shape[0]} +join div",
                      work, timed=False)
                if not torch.equal(last_check["out"], a):
                    fail(f"K7's two joins disagree on b{i}.c3")
            paths_since(_kernels, "expand_add", k7_before, "wgmma_tma",
                        f"b{i}.c3")
            if i == 0:
                # the residual 4 bytes off 16: TMA refuses it, so the call
                # takes mma_sync, K7's path for such bases and channel counts
                N, O, H, W = r.shape
                ru = torch.empty(r.numel() + 4, dtype=torch.int8,
                                 device=dev)[4:].view(N, H, W, O).permute(
                                     0, 3, 1, 2)
                ru.copy_(r)
                argsu = (*args[:4], ru, *rs)
                for s_inv in dict.fromkeys((inv, None)):
                    join = "inv" if s_inv is not None else "div"
                    before_u = dict(_kernels.KERNELS["expand_add"].variants)
                    check("expand_add", "b0.c3u",
                          lambda: expand_add_int8(*argsu, inv_out=s_inv),
                          lambda: expand_add_int8_plain(*argsu,
                                                        inv_out=s_inv),
                          f"x{list(y.shape)} O{O} +join {join}, r off 16 B",
                          work, timed=False, plan=expand_plan(*argsu[:5]))
                    paths_since(_kernels, "expand_add", before_u, "mma_sync",
                                f"b0.c3, the residual off 16 bytes, {join}")
                    if not torch.equal(last_check["out"], a):
                        fail(f"K7 on mma_sync != wgmma_tma at b0.c3 ({join})")

            def k2_c3():
                return c3(y, conv2d_int8, residual=r, res_scales=rs)
            if not torch.equal(k2_c3(), a):
                fail(f"K2 and K7 disagree on b{i}.c3")
            ms = time_ms(k2_c3, 10)
            print(f"{'':12s} b{i}.c3  K2 (k1 +join) on the same c3 "
                  f"{ms:.4f} ms  ({label})")
            st = k7_stages.setdefault(stage_of[50][f"b{i}.c3"], [0.0] * 5)
            for j, v in enumerate((*k7, ms, 1)):
                st[j] += v
        fc_case(mod50, a)
    summary("ResNet-50 walk", before,
            ("stem_fused", "conv_int8", "expand_add", "matmul_int8"))
    for stage, (ms, bnd, lib, k2ms, n) in sorted(k7_stages.items()):
        print(f"K7 ResNet-50 stage {stage} ({n} c3): {ms:.4f} ms, bound "
              f"{bnd:.4f} ms ({ms / bnd:.1f}x), _int_mm {lib:.4f} ms, "
              f"K2 +join {k2ms:.4f} ms  ({label})")
    print(f"K7 ResNet-50, 16 c3: "
          f"{sum(v[0] for v in k7_stages.values()):.4f} ms, bound "
          f"{sum(v[1] for v in k7_stages.values()):.4f} ms, _int_mm "
          f"{sum(v[2] for v in k7_stages.values()):.4f} ms, K2 +join "
          f"{sum(v[3] for v in k7_stages.values()):.4f} ms  ({label})")
    paths_since(_kernels, "conv_int8", k2_before, "wgmma_tma",
                "the ResNet-50 walk")
    k2_stage_lines(50)
    del mod50

    # ---- 6. ResNet-50 through the engine ------------------------------
    engine50 = InferenceEngine(model50, device="cuda")
    results50, launches50 = served_launches(
        _kernels, lambda: [engine50.run_inference(xb) for xb in batches],
        ["stem_fused", "conv_int8", "matmul_int8", "expand_add"],
        f"ResNet-50, {len(batches)} batches of {BATCH}",
        {"matmul_int8": "wgmma_tma",
         "conv_int8": {"wgmma_tma": 36 * len(batches)},
         "expand_add": {"wgmma_tma": 16 * len(batches)}})
    if launches50["expand_add"] != 16 * len(batches):
        fail(f"expand_add launched {launches50['expand_add']} times, not "
             f"16 a batch")
    with torch.inference_mode():
        for b, (xb, res) in enumerate(zip(batches, results50)):
            if res.logits.shape != (BATCH, CLASSES) or \
                    not np.isfinite(res.logits).all():
                fail(f"ResNet-50 batch {b}: logits {res.logits.shape} not "
                     f"finite [{BATCH}, {CLASSES}]")
            plain = engine50.module.forward_plain(
                torch.from_numpy(xb).to(dev)).cpu().numpy()
            if not np.array_equal(res.logits, plain):
                fail(f"ResNet-50 batch {b}: logits differ from the plain "
                     f"path (max |err| {np.abs(res.logits - plain).max()})")
        cpu = ResNet18Int8Module(model50, "cpu")(
            torch.from_numpy(batches[0][:2])).numpy()
    if not np.array_equal(results50[0].logits[:2], cpu):
        fail("ResNet-50 logits differ from the plain path on the CPU")
    print(f"ResNet-50 logits: {len(batches)} x [{BATCH}, {CLASSES}] finite, "
          f"bit-identical to the plain path on the card and (2 images) on "
          f"the CPU; top-1 of batch 0: {results50[0].predictions[:8]}")
    bench = engine50.benchmark(batches[0], iters=10)
    print(f"ResNet-50 forward batch {BATCH}: {bench.latency_s * 1e3:.3f} ms "
          f"median, {bench.images_per_s:.1f} img/s; run_inference incl. "
          f"copies: {[round(r.images_per_s, 1) for r in results50]} img/s  "
          f"({label})")
    del engine50

    # ---- 7. sparse ResNet-18: K4 at every sparse conv -----------------
    t0 = time.perf_counter()
    pruned = quantize_resnet18(
        prune_params_blockwise(params, sparsity=SPARSITY, block=BLOCK),
        calib, CLASSES)
    sparse = attach_bsr(pruned, block=BLOCK, min_sparsity=0.25)
    print(f"prune {SPARSITY} at {BLOCK}, quantize, attach BSR on the CPU: "
          f"{time.perf_counter() - t0:.1f} s")
    bsr_of = {name: qc.bsr for name, qc in sparse.named_convs()
              if qc.bsr is not None}
    print(f"{len(bsr_of)} sparse convs: " + ", ".join(
        f"{n} {b.nnz_blocks}/{b.total_blocks}" for n, b in bsr_of.items()))
    if not bsr_of:
        fail("attach_bsr gave no layer BSR weights")
    smod = ResNet18Int8Module(sparse, dev).eval()
    dmod = ResNet18Int8Module(pruned, dev).eval()
    im2col_total = dense_total = 0.0
    k2_before = dict(_kernels.KERNELS["conv_int8"].variants)
    with torch.inference_mode():
        a = stem_conv_pool(x, smod.stem_k1_w, smod.stem.bias,
                           smod.stem.factors, smod.s_input)
        for i, (convs, dconvs, rs) in enumerate(
                zip(smod.blocks, dmod.blocks, smod.res_scales)):
            def run(tag, inp, **join):
                nonlocal im2col_total, dense_total
                cv, dcv = convs[tag], dconvs[tag]
                if cv.packed is None:
                    return cv(inp, conv2d_int8, **join)
                N, _, H, W = inp.shape
                Ho = (H + 2 * cv.padding - cv.kernel) // cv.stride + 1
                Wo = (W + 2 * cv.padding - cv.kernel) // cv.stride + 1

                def im2col():
                    return im2col_nchw(inp, cv.kernel, cv.stride,
                                       cv.padding).reshape(N * Ho * Wo, -1)
                im_ms = time_ms(im2col, 5)
                A, pk = im2col(), cv.packed
                kw = dict(bias=cv.bias, factors=cv.factors, relu=cv.relu)
                q = check("bsr_matmul", f"b{i}.{tag}",
                          lambda: bsr_matmul_wt(A, pk, **kw),
                          lambda: bsr_matmul_wt_plain(A, pk, **kw),
                          f"A{list(A.shape)} N{pk.n_out} "
                          f"{pk.nnz_source}/{pk.total_source} blocks",
                          lambda out: bsr_work(A, pk, out),
                          library=int_mm_call(A, densify(pk)),
                          plan=bsr_plan(A, pk, n_sms))
                d_ms = time_ms(lambda: dcv(inp, conv2d_int8, **join), 10)
                im2col_total += im_ms
                dense_total += d_ms
                print(f"{'':12s} b{i}.{tag:3s} im2col {im_ms:.4f} ms; dense "
                      f"K2 on the pruned conv{' +join' if join else ''} "
                      f"{d_ms:.4f} ms  ({label})")
                q = q.view(N, Ho, Wo, -1).permute(0, 3, 1, 2)
                if join:
                    q = add_residual(q, join["residual"],
                                     *join["res_scales"], relu=True)
                    q = q.contiguous(memory_format=cl)
                return q
            y = run("c1", a)
            r = run("ds", a) if "ds" in convs else a
            a = run("c2", y, residual=r, res_scales=rs)
    paths_since(_kernels, "conv_int8", k2_before, "wgmma_tma",
                "the sparse ResNet-18 walk")
    s4 = stats["bsr_matmul"]
    summary(f"sparse convs ({len(bsr_of)})", {k: dict.fromkeys(v, 0.0)
                                              for k, v in stats.items()},
            ("bsr_matmul",))
    print(f"sparse convs ({len(bsr_of)}): K4 {s4['ms']:.4f} ms + im2col "
          f"{im2col_total:.4f} ms vs dense K2 {dense_total:.4f} ms; K4 "
          f"plain {s4['plain_ms']:.4f} ms  ({label})")

    # ---- 8. the sparse slice through the engine -----------------------
    sengine = InferenceEngine(sparse, device="cuda")
    sresults, slaunches = served_launches(
        _kernels, lambda: [sengine.run_inference(xb) for xb in batches],
        ["stem_fused", "conv_int8", "matmul_int8", "bsr_matmul"],
        f"sparse ResNet-18, {len(batches)} batches of {BATCH}",
        {"matmul_int8": "wgmma_tma", "bsr_matmul": "wgmma_tma",
         "conv_int8": "wgmma_tma"})
    dengine = InferenceEngine(pruned, device="cuda")
    with torch.inference_mode():
        for b, (xb, res) in enumerate(zip(batches, sresults)):
            xt = torch.from_numpy(xb).to(dev)
            for what, ref in (
                    ("the plain path", sengine.module.forward_plain(xt)),
                    ("the dense forward of the pruned model",
                     dengine.module(xt))):
                ref = ref.cpu().numpy()
                if res.logits.shape != (BATCH, CLASSES) or \
                        not np.array_equal(res.logits, ref):
                    fail(f"sparse batch {b}: logits differ from {what}")
        cpu = ResNet18Int8Module(sparse, "cpu")(
            torch.from_numpy(batches[0][:2])).numpy()
    if not np.array_equal(sresults[0].logits[:2], cpu):
        fail("sparse logits differ from the plain path on the CPU")
    print(f"sparse logits: {len(batches)} x [{BATCH}, {CLASSES}], "
          f"bit-identical to the plain path on the card, (2 images) on the "
          f"CPU and to the dense forward of the pruned model")
    for eng, what in ((dengine, "dense"), (sengine, "sparse"),
                      (sengine, "sparse"), (dengine, "dense")):
        bench = eng.benchmark(batches[0], iters=10)
        print(f"pruned model, {what:6s} forward batch {BATCH}: "
              f"{bench.latency_s * 1e3:.3f} ms median, "
              f"{bench.images_per_s:.1f} img/s  ({label})")
    del sengine, dengine, smod, dmod

    # ---- 9. the MNIST CNN -----------------------------------------------
    tmp = tempfile.TemporaryDirectory()
    int8_dir = os.path.join(tmp.name, "int8")
    os.mkdir(int8_dir)
    mnist_int8_dir(int8_dir, SEED)
    digits = np.random.default_rng(SEED + 1).integers(
        0, 256, (BATCH, 28, 28)).astype(np.uint8)
    digits_path = os.path.join(tmp.name, "digits.npy")
    np.save(digits_path, digits)
    mnist = MNISTCNNInt8.from_int8_dir(int8_dir, digits).with_fc1_bsr(BLOCK)
    print(f"MNIST CNN: fc1 sparsity {mnist.sparsity_report()}")
    xm = preprocess_mnist(digits)
    mengine = InferenceEngine(mnist, device="cuda")
    mm = mengine.module
    with torch.inference_mode():
        xt = torch.from_numpy(xm).to(dev)
        f = torch.nn.functional.pad(quantize_input(xt, mm.s_input),
                                    (0, 0, 0, 0, 0, 3))
        f = conv2d_int8(f.contiguous(memory_format=cl), mm.conv1_w,
                        mm.conv1_b, mm.conv1_f, relu=True)
        f = conv2d_int8(f, mm.conv2_w, mm.conv2_b, mm.conv2_f, relu=True)
        f = maxpool2d_int8(f, 2, 2).contiguous().reshape(BATCH, -1)
        kw = dict(bias=mm.fc1_b, factors=mm.fc1_f, relu=True)
        pk = mm.fc1_packed
        check("bsr_matmul", "fc1",
              lambda: bsr_matmul_wt(f, pk, **kw),
              lambda: bsr_matmul_wt_plain(f, pk, **kw),
              f"A{list(f.shape)} N{pk.n_out} "
              f"{pk.nnz_source}/{pk.total_source} blocks (MNIST)",
              lambda out: bsr_work(f, pk, out),
              library=int_mm_call(f, densify(pk)), timed=False,
              plan=bsr_plan(f, pk, n_sms))
        # K3 at the MNIST shapes: fc1 dense (requant, ReLU) and fc2
        w1 = torch.from_numpy(mnist.fc1_w).to(dev).t()
        for name, a3, w3, kw3 in (
                ("fc1", f, w1, dict(bias=mm.fc1_b, factors=mm.fc1_f,
                                    relu=True)),
                ("fc2", matmul_int8(f, w1, bias=mm.fc1_b, factors=mm.fc1_f,
                                    relu=True), mm.fc2_wT,
                 dict(bias=mm.fc2_b))):
            (M3, K3), N3 = a3.shape, w3.shape[1]
            lib3 = int_mm_call(a3, w3.t())

            def work3(out, M3=M3, K3=K3, N3=N3):
                return (M3 * K3 + K3 * N3 + 8 * N3 + out.numel()
                        * out.element_size(), 2 * M3 * K3 * N3, "int8")
            check("matmul_int8", name,
                  lambda: matmul_int8(a3, w3, **kw3),
                  lambda: matmul_int8_plain(a3, w3, **kw3),
                  f"a{list(a3.shape)} b{list(w3.shape)} (MNIST, dense)",
                  work3, library=None if lib3 is None else (
                      lambda: lib3() + kw3["bias"]), timed=False,
                  plan=matmul_plan(a3, w3.t(), n_sms))
    mres, mlaunches = served_launches(
        _kernels, lambda: mengine.run_inference(xm),
        ["conv_int8", "matmul_int8", "bsr_matmul"],
        f"MNIST CNN, a batch of {BATCH}",
        {"matmul_int8": "wgmma_tma", "bsr_matmul": "wgmma_tma",
         "conv_int8": {"mma_sync": 1, "wgmma_tma": 1}})
    with torch.inference_mode():
        plain = mm.forward_plain(torch.from_numpy(xm).to(dev)).cpu().numpy()
        cpu = MNISTCNNInt8Module(mnist, "cpu")(torch.from_numpy(xm)).numpy()
    if mres.logits.shape != (BATCH, 10) or not np.isfinite(mres.logits).all():
        fail(f"MNIST logits {mres.logits.shape} not finite [{BATCH}, 10]")
    if not (np.array_equal(mres.logits, plain)
            and np.array_equal(mres.logits, cpu)):
        fail("MNIST logits differ from the plain path")
    print(f"MNIST logits [{BATCH}, 10] bit-identical to the plain path on "
          f"the card and on the CPU; {len(np.unique(mres.predictions))} "
          f"distinct classes predicted")

    # ---- 10. the CLI: bench sweep and MNIST inference ------------------
    for args, expect in (
            (["bench", "--sizes", "2048,4096", "--sparsities",
              "0.0,0.5,0.7,0.9", "--batch", "512", "--device", "cuda"],
             "'sparsity': 0.9"),
            (["infer", "--model", "mnist", "--weights", int8_dir,
              "--input", digits_path, "--device", "cuda", "--limit", "4"],
             "sample 3:")):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "resnet_accel_tpu_torch", *args],
            cwd=repo, capture_output=True, text=True, timeout=600)
        print(proc.stdout, end="")
        print(f"{args[0]}: {time.perf_counter() - t0:.1f} s  ({label})")
        if proc.returncode != 0 or expect not in proc.stdout:
            print(proc.stderr, file=sys.stderr)
            fail(f"CLI {args[0]} exited {proc.returncode}")
    tmp.cleanup()

    # ---- 11. the serving LM, seeded and calibrated on the CPU ---------
    t0 = time.perf_counter()
    lm = TransformerLMInt8.from_random(**LM_CFG, seed=SEED)
    calib = np.random.default_rng(SEED).integers(
        0, LM_CFG["vocab"], min(16, LM_CFG["max_len"])).astype(np.int32)
    lm_scales = lm.calibrate(calib)
    print(f"LM {LM_CFG} seed {SEED}: init + calibrate on the CPU "
          f"{time.perf_counter() - t0:.1f} s; sparsity "
          f"{lm.blocks[0].sparsity_report()}")
    prng = np.random.default_rng(SEED + 2)
    prompt = prng.integers(0, LM_CFG["vocab"], PROMPT).astype(np.int32)
    prompts = prng.integers(0, LM_CFG["vocab"],
                            (LM_BATCH, PROMPT)).astype(np.int32)
    lmod = lm.module("cuda")
    sc = lmod.prepare_scales(lm_scales)

    # ---- 12. K5 at the prefill's shapes, every layer ------------------
    H, dh = LM_CFG["n_heads"], LM_CFG["d_model"] // LM_CFG["n_heads"]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    flips = {}      # int8 ctx values rounded apart, by prompt batch
    with torch.inference_mode():
        for toks, timed in ((prompt, True), (prompts, False)):
            flips[toks.ndim] = 0
            x = lmod.embed[lmod._tokens(toks)] + lmod.pos[:PROMPT]
            for i, blk in enumerate(lmod.blocks):
                qh, kh, vh = (blk._heads(t).reshape(-1, PROMPT, dh)
                              .contiguous() for t in blk.qkv_project(x, sc[i]))
                BH = qh.shape[0]

                pairs = PROMPT * (PROMPT + 1) // 2            # causal
                flops = 4 * BH * dh * pairs

                def work(out, flops=flops):
                    return 4 * qh.numel() * 4, flops, "tf32x3"
                want = check(
                    "flash_attention", f"l{i}",
                    lambda: flash_attention(qh, kh, vh, causal=True),
                    lambda: flash_attention_plain(qh, kh, vh, causal=True),
                    f"q,k,v [{BH}, {PROMPT}, {dh}] fp32 causal", work,
                    library=lambda: sdpa(qh, kh, vh, is_causal=True),
                    timed=timed, tol=2e-5)
                # the wo projection quantizes ctx: count the int8 values
                # that K5's and the plain version's rounding put apart
                apart = int((blk._quant(flash_attention(
                    qh, kh, vh, causal=True), sc[i]["ctx"])
                    != blk._quant(want, sc[i]["ctx"])).sum())
                flips[toks.ndim] += apart
                print(f"{'':12s} l{i}     SDPA max |err| vs plain "
                      f"{max_abs_err(sdpa(qh, kh, vh, is_causal=True), want):.3g}"
                      f"; int8 ctx values K5 and plain quantize apart: "
                      f"{apart} of {want.numel()}; bound at the FFMA rate "
                      f"{bound_ms(0, flops, 'fp32')[1]:.4f} ms")
                x = blk(x, causal=True, scales=sc[i], flash=True, plain=True)

    summary(f"K5 over one prompt's prefill (BH {H}, 4 layers)",
            {k: dict.fromkeys(v, 0.0) for k, v in stats.items()},
            ("flash_attention",))

    # ---- 13. greedy generation through the module ----------------------
    def serve_lm():
        return (lmod.generate(prompt, N_NEW, lm_scales, flash=True),
                lmod.generate(prompts, N_NEW, lm_scales, flash=True,
                              batched=True))
    t0 = time.perf_counter()
    (toks1, toks8), llaunches = served_launches(
        _kernels, serve_lm, ["flash_attention"],
        f"LM generate(flash=True): 1 prompt and {LM_BATCH} batched, "
        f"{PROMPT} -> {N_NEW}")
    print(f"both generate calls: {time.perf_counter() - t0:.1f} s")
    if llaunches["flash_attention"] != 2 * LM_CFG["n_layers"]:
        fail(f"flash_attention launched {llaunches['flash_attention']} "
             f"times, not {LM_CFG['n_layers']} a prefill")
    if toks1.shape != (N_NEW,) or toks8.shape != (LM_BATCH, N_NEW) or \
            toks8.min() < 0 or toks8.max() >= LM_CFG["vocab"]:
        fail(f"generated tokens of shape {toks1.shape}, {toks8.shape}")
    plain1 = lmod.generate(prompt, N_NEW, lm_scales, flash=True, plain=True)
    plain8 = lmod.generate(prompts, N_NEW, lm_scales, flash=True,
                           batched=True, plain=True)
    if not (np.array_equal(toks1, plain1) and np.array_equal(toks8, plain8)):
        fail("generated tokens differ from the plain path on the card")
    for b in range(LM_BATCH):
        if not np.array_equal(toks8[b], lmod.generate(
                prompts[b], N_NEW, lm_scales, flash=True)):
            fail(f"batched row {b} differs from its single-prompt run")
    # The prefill's logits (its readout, the last row) against the plain
    # path's: within 1e-4 unless K5's and the plain version's float32 sums
    # rounded some attention output to neighbouring int8 values at the wo
    # projection (counted in phase 12 on the same inputs); such a value
    # moves every later activation by a whole int8 step, so then the
    # logits are only reported.  Rows of the teacher-forced forward too.
    for toks, what in ((prompt, "1 prompt"), (prompts, f"{LM_BATCH}")):
        got = lmod.prefill(toks, sc, flash=True)[0]
        ref = lmod.prefill(toks, sc, flash=True, plain=True)[0]
        err = max_abs_err(got, ref)
        within = torch.allclose(got, ref, rtol=1e-4, atol=1e-4)
        if got.shape != ref.shape or got.shape[-1] != LM_CFG["vocab"] or \
                not torch.isfinite(got).all():
            fail(f"prefill logits {tuple(got.shape)} not finite")
        if not within and flips[toks.ndim] == 0:
            fail(f"prefill logits differ from the plain path (max |err| "
                 f"{err}) with no int8 value rounded apart")
        print(f"prefill logits, {what}: max |err| vs plain {err:.3g} "
              f"({'within' if within else 'beyond'} 1e-4; "
              f"{flips[toks.ndim]} int8 ctx values rounded apart)")
    logits = lmod.forward(prompt, lm_scales, flash=True)
    logits_p = lmod.forward(prompt, lm_scales, flash=True, plain=True)
    close = torch.isclose(logits, logits_p, rtol=1e-4, atol=1e-4).all(-1)
    if not torch.isfinite(logits).all():
        fail("forward logits are not finite")
    print(f"LM tokens equal the plain path on the card (1 prompt and "
          f"{LM_BATCH} batched; each batched row equals its own run); "
          f"teacher-forced forward [{PROMPT}, {LM_CFG['vocab']}]: "
          f"{int(close.sum())} of {PROMPT} rows within 1e-4 of the plain "
          f"path, max |err| {max_abs_err(logits, logits_p):.3g}; first "
          f"tokens {toks1[:12].tolist()}, {len(np.unique(toks8))} distinct "
          f"in the batch")

    def timed_generate(toks):
        """Host clock to a sync, medians of 3: the prefill, the N_NEW - 1
        decode steps after it (per step) and the whole generation."""
        pre, dec = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            last, caches = lmod.prefill(toks, sc, flash=True)
            tok = last.argmax(dim=-1)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(N_NEW - 1):
                logits, caches = lmod.decode_step(caches, tok, sc)
                tok = logits.argmax(dim=-1)
            torch.cuda.synchronize()
            pre.append((t1 - t0) * 1e3)
            dec.append((time.perf_counter() - t1) * 1e3)
        pre_ms, dec_ms = statistics.median(pre), statistics.median(dec)
        return pre_ms, dec_ms / (N_NEW - 1), (pre_ms + dec_ms) / 1e3
    with torch.inference_mode():
        for toks, B in ((prompt, 1), (prompts, LM_BATCH)):
            pre_ms, step_ms, total_s = timed_generate(toks)
            print(f"LM generate, batch {B}, {PROMPT} -> {N_NEW}: prefill "
                  f"{pre_ms:.3f} ms, decode {step_ms:.3f} ms a step, "
                  f"{B * N_NEW / total_s:.1f} tokens/s (host clock, median "
                  f"of 3)  ({label})")

    with torch.inference_mode():
        last, caches = lmod.prefill(prompt, sc, flash=True)
        profiled(f"prefill of {PROMPT} tokens (batch 1)",
                 lambda: lmod.prefill(prompt, sc, flash=True), label)
        tok = last.argmax(dim=-1)

        def decode32():
            nonlocal caches, tok
            for _ in range(32):
                logits, caches = lmod.decode_step(caches, tok, sc)
                tok = logits.argmax(dim=-1)
        profiled("32 decode steps (batch 1)", decode32, label)

    # ---- 14. the CLI: generate --flash ---------------------------------
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "resnet_accel_tpu_torch", "generate",
         "--flash", "--prompt", ",".join(map(str, prompt.tolist())),
         "--n-new", str(N_NEW), "--layers", str(LM_CFG["n_layers"]),
         "--d-model", str(LM_CFG["d_model"]),
         "--heads", str(LM_CFG["n_heads"]), "--vocab", str(LM_CFG["vocab"]),
         "--max-len", str(LM_CFG["max_len"]),
         "--sparsity", str(LM_CFG["sparsity"]), "--seed", str(SEED)],
        cwd=repo, capture_output=True, text=True, timeout=600)
    print("\n".join(ln[:160] for ln in proc.stdout.splitlines()))
    print(f"generate --flash: {time.perf_counter() - t0:.1f} s  ({label})")
    if proc.returncode != 0 or \
            f"generated: {toks1.tolist()}" not in proc.stdout:
        print(proc.stderr, file=sys.stderr)
        fail(f"CLI generate --flash exited {proc.returncode} or its tokens "
             f"differ from generate(flash=True)")

    # ---- 15. the conv sweep: K8 against its plain version and K2 ------
    sweep_rng = np.random.default_rng(1)      # bench --conv's data
    speedups, k8_case_ms = {}, {}
    k2_before = dict(_kernels.KERNELS["conv_int8"].variants)
    k8_before = dict(_kernels.KERNELS["sparse_conv"].variants)
    with torch.inference_mode():
        for name, C, O, H, k, s, p in cli.CONV_CASES:
            xs = torch.from_numpy(sweep_rng.integers(
                -128, 128, (SWEEP_BATCH, C, H, H)).astype(np.int8)).to(
                dev).contiguous(memory_format=cl)
            w = tap_sparse_weight(sweep_rng, O, C, k, SWEEP_SPARSITY)
            fct = torch.full((O,), 0.001, dtype=torch.float32, device=dev)
            zero = torch.zeros(O, dtype=torch.int32, device=dev)
            pk = device_pack(pack_conv_bsr(w, padding=p), dev)
            wd = pack_weight(w.reshape(O, -1), C, k, dev)
            kw = dict(factors=fct, relu=True, stride=s)

            def work(out, xs=xs, pk=pk, s=s):
                return sconv_work(xs, pk, s, out)
            got = check("sparse_conv", name.split()[0],
                        lambda: sparse_conv2d_int8(xs, pk, **kw),
                        lambda: sparse_conv2d_int8_plain(xs, pk, **kw),
                        f"x{list(xs.shape)} k{k} s{s} O{O} "
                        f"{pk.nnz_source}/{pk.total_source} blocks", work,
                        plan=sparse_conv_plan(xs, pk))
            k8_ms = k8_case_ms[name] = last_check["ms"]

            def dense():
                return conv2d_int8(xs, wd, zero, fct, stride=s, padding=p,
                                   relu=True)
            if not torch.equal(dense(), got):
                fail(f"K8 and the dense K2 disagree at {name}")
            d_ms = time_ms(dense, 10)
            speedups[name] = d_ms / k8_ms
            print(f"{'':12s} {name}: K8 {k8_ms:.4f} ms, dense K2 "
                  f"{d_ms:.4f} ms (equal to K8), K8's bound "
                  f"{last_check['bound_ms']:.4f} ms; speedup_vs_dense "
                  f"{speedups[name]:.3f}  ({label})")
    summary("conv sweep (4 cases)", {k: dict.fromkeys(v, 0.0)
                                     for k, v in stats.items()},
            ("sparse_conv",))
    paths_since(_kernels, "conv_int8", k2_before, "wgmma_tma",
                "the conv sweep's dense K2")
    paths_since(_kernels, "sparse_conv", k8_before, "wgmma_tma",
                "the conv sweep's K8 at 128 x 128")

    def sweep_lines(text, what):
        rows = [json.loads(ln) for ln in text.splitlines()
                if ln.startswith("{")]
        if len(rows) != 4 or any(r.get("kind") != "conv" for r in rows):
            fail(f"{what} printed {len(rows)} conv lines, not 4")
        return rows
    buf = io.StringIO()

    def sweep():
        with contextlib.redirect_stdout(buf):
            return cli.main(["bench", "--conv", "--device", "cuda"])
    rc, claunches = served_launches(
        _kernels, sweep, ["sparse_conv", "conv_int8"],
        "the conv sweep (bench --conv), 4 cases",
        {"conv_int8": "wgmma_tma", "sparse_conv": "wgmma_tma"})
    print(buf.getvalue(), end="")
    sweep_lines(buf.getvalue(), "bench --conv")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "resnet_accel_tpu_torch", "bench", "--conv",
         "--device", "cuda"], cwd=repo, capture_output=True, text=True,
        timeout=600)
    print(proc.stdout, end="")
    print(f"bench --conv (subprocess): {time.perf_counter() - t0:.1f} s  "
          f"({label})")
    if proc.returncode != 0:
        print(proc.stderr, file=sys.stderr)
        fail(f"CLI bench --conv exited {proc.returncode}")
    sweep_lines(proc.stdout, "bench --conv (subprocess)")

    # ---- 16. K10 at ResNet-18's stem ----------------------------------
    x0 = torch.from_numpy(batches[0]).to(dev)
    q0 = quantize_input(x0, mod.s_input)
    st = mod.stem
    with torch.inference_mode():
        for pool in (True, False):
            def work(out):
                N, _, H, W = q0.shape
                Hc, Wc = (H - 1) // 2 + 1, (W - 1) // 2 + 1
                return (q0.numel() + st.weight.numel() + 8 * 64
                        + out.numel(),
                        2 * N * 64 * Hc * Wc * st.weight[0].numel(), "int8")
            args = (q0, mod.stem_k1_w, st.bias, st.factors, pool)
            k10 = check("stem_int8", "pooled" if pool else "conv",
                        lambda: stem_conv_pool_int8(*args),
                        lambda: stem_conv_pool_int8_plain(*args),
                        f"q{list(q0.shape)} int8", work)
            if pool and not torch.equal(k10, stem_conv_pool(
                    x0, mod.stem_k1_w, st.bias, st.factors, mod.s_input)):
                fail("K10 of the quantized images differs from K1 of the "
                     "fp32 ones")
        # the card tests' geometries (odd W: byte loads; even: 16-bit), on
        # the OIHW and the packed weight, and saturated values
        grng = np.random.default_rng(SEED + 7)
        geoms = [(2, 232, 232, False), (1, 37, 50, False),
                 (1, 28, 16, False), (1, 31, 29, False),
                 (12, 224, 224, False), (2, 64, 48, True), (1, 31, 29, True)]
        for N, H, W, sat in geoms:
            if sat:
                qg = torch.from_numpy(grng.choice(
                    np.int8([-128, 127, 0]), (N, 3, H, W))).to(dev)
                wg = grng.choice(np.int8([-128, 127, -127]), (64, 3, 7, 7))
                fg = grng.uniform(2e-5, 6e-5, 64)
            else:
                xg = torch.from_numpy(grng.normal(0, 1, (N, 3, H, W)).astype(
                    np.float32)).to(dev)
                sg = float(xg.abs().max()) / 127.0
                qg = quantize_input(xg, sg)
                wg = grng.integers(-128, 128, (64, 3, 7, 7))
                fg = grng.uniform(0.001, 0.01, 64)
            wg = torch.from_numpy(wg.astype(np.int8)).to(dev)
            fg = torch.from_numpy(fg.astype(np.float32)).to(dev)
            bg = torch.from_numpy(grng.integers(-5000, 5000, 64).astype(
                np.int32)).to(dev)
            for pool in (True, False):
                want = stem_conv_pool_int8_plain(qg, wg, bg, fg, pool)
                for wk in (wg, pack_stem_weight(wg)):
                    if not torch.equal(stem_conv_pool_int8(
                            qg, wk, bg, fg, pool), want):
                        fail(f"K10 {'pooled' if pool else 'unpooled'} "
                             f"differs from its plain version at "
                             f"{(N, H, W)}{' saturated' if sat else ''}, "
                             f"weight {list(wk.shape)}")
                if pool and not sat and not torch.equal(
                        want, stem_conv_pool(xg, wg, bg, fg, sg)):
                    fail(f"K10 differs from K1 at {(N, H, W)}")
    print(f"K10 pooled equals K1 on the fp32 images it came from; pooled "
          f"and unpooled equal the plain version, OIHW and packed weight, "
          f"at {', '.join(str(g[:3]) for g in geoms if not g[3])} and "
          f"saturated at {', '.join(str(g[:3]) for g in geoms if g[3])}  "
          f"({label})")

    # ---- 17. the int8 stream ----------------------------------------------
    qengine = InferenceEngine(model, device="cuda")
    loader = QuantizingLoader(np.concatenate(batches), model.s_input, BATCH)
    qres, qlaunches = served_launches(
        _kernels, lambda: qengine.stream(loader, len(batches)),
        ["stem_int8", "conv_int8", "matmul_int8"],
        f"int8 stream, {len(batches)} batches of {BATCH}",
        {"matmul_int8": "wgmma_tma",
         "conv_int8": {"wgmma_tma": 19 * len(batches)}})
    if qlaunches["stem_fused"] != 0:
        fail("the int8 stream launched K1")
    with torch.inference_mode():
        for b, xb in enumerate(batches):
            got = qres.logits[b * BATCH:(b + 1) * BATCH]
            if got.shape != (BATCH, CLASSES) or not np.isfinite(got).all():
                fail(f"int8 stream batch {b}: logits {got.shape} not finite")
            xt = torch.from_numpy(xb).to(dev)
            qb = quantize_input(xt, model.s_input)
            for what, ref in (("the plain path", mod.forward_plain(qb)),
                              ("the fp32-input forward", mod(xt))):
                if not np.array_equal(got, ref.cpu().numpy()):
                    fail(f"int8 stream batch {b}: logits differ from {what}")
        cpu = ResNet18Int8Module(model, "cpu")(
            quantize_input(torch.from_numpy(batches[0][:2]), model.s_input))
    if not np.array_equal(qres.logits[:2], cpu.numpy()):
        fail("int8 stream logits differ from the plain path on the CPU")
    print(f"int8 stream logits: {len(batches)} x [{BATCH}, {CLASSES}] "
          f"finite, bit-identical to the plain path on the card, to the "
          f"fp32-input forward and (2 images) to the plain path on the CPU")
    with torch.inference_mode():
        # in the order fp32, int8, int8, fp32
        t_fp32 = [time_ms(lambda: mod(x0), 10)]
        t_int8 = [time_ms(lambda: mod(q0), 10) for _ in range(2)]
        t_fp32.append(time_ms(lambda: mod(x0), 10))
    print(f"int8 stream: {qres.images_per_s:.1f} img/s over batches 2-3 "
          f"(CUDA events, host quantize and pinned upload included); "
          f"forward batch {BATCH} on the card: int8 input "
          f"{t_int8[0]:.4f} / {t_int8[1]:.4f} ms, fp32 input "
          f"{t_fp32[0]:.4f} / {t_fp32[1]:.4f} ms (median of 10 each, in "
          f"the order fp32, int8, int8, fp32): int8 / fp32 "
          f"{sum(t_int8) / sum(t_fp32):.3f}  ({label})")
    del qengine

    # ---- 18. K6 at the stem's batch, ties, odd batches ------------------
    s_in = model.s_input
    with torch.inference_mode():
        def k6_work(out):
            return (x0.numel() * 4 + out.numel(), x0.numel(), "fp32")
        check("stem_pack", "stem",
              lambda: quantize_s2d(x0, s_in),
              lambda: quantize_s2d_nchw(x0, s_in),
              f"x{list(x0.shape)} fp32", k6_work)
        print(f"{'':12s} K6 bound at batch {BATCH}: "
              f"{last_check['bound_ms']:.4f} ms (bytes: "
              f"{x0.numel() * 4 / 1e6:.2f} MB in, "
              f"{x0.numel() / 1e6:.2f} MB out)  ({label})")
        k = np.arange(-140, 140, dtype=np.float32)
        ties = np.concatenate([(k + np.float32(0.5)) * np.float32(s_in),
                               k * np.float32(s_in),
                               np.float32([1e6, -1e6, 0.0, -0.0])])
        ties = np.resize(ties, (3, 3, 20, 12)).astype(np.float32)
        want = np.clip(np.rint(ties / np.float32(s_in)), -128, 127).astype(
            np.int8).reshape(3, 3, 10, 2, 6, 2).transpose(
            0, 1, 3, 5, 2, 4).reshape(3, 12, 10, 6)
        for xs in (torch.from_numpy(ties).to(dev), x0[:1], x0[:3]):
            got = quantize_s2d(xs, s_in)
            torch.cuda.synchronize()
            if not torch.equal(got, quantize_s2d_nchw(xs, s_in)):
                fail(f"K6 differs from its plain version at "
                     f"{list(xs.shape)}")
        if not np.array_equal(quantize_s2d(torch.from_numpy(ties).to(dev),
                                           s_in).cpu().numpy(), want):
            fail("K6 rounds the ties apart from numpy's rint(x / s)")
    print(f"K6 equals its plain version at batch {BATCH}, 1 and 3, and on "
          f"{ties.size} values with exact ties and saturation  ({label})")

    # ---- 19. the space-to-depth stem against K1 --------------------------
    st = mod.stem
    w4 = pack_weight(stem_s2d_weights(model.stem.w2d, 3, 7), 12, 4, dev)
    pad = ((2, 1), (2, 1))
    k2_before = dict(_kernels.KERNELS["conv_int8"].variants)
    with torch.inference_mode():
        q12 = quantize_s2d(x0, s_in)
        pre = conv2d_int8(q12, w4, st.bias, st.factors, padding=pad,
                          relu=True)
        route = maxpool2d_int8(pre, 3, 2, padding=1)
        k1_w = mod.stem_k1_w
        k1 = stem_conv_pool(x0, k1_w, st.bias, st.factors, s_in)
        if not torch.equal(route, k1):
            fail("K6 -> K2 4x4 -> max pool differs from K1")
        parts = {
            "K6": time_ms(lambda: quantize_s2d(x0, s_in), 10),
            "K2 4x4": time_ms(lambda: conv2d_int8(
                q12, w4, st.bias, st.factors, padding=pad, relu=True), 10),
            "max pool": time_ms(lambda: maxpool2d_int8(
                pre, 3, 2, padding=1).contiguous(memory_format=cl), 10),
            "K1": time_ms(lambda: stem_conv_pool(x0, k1_w, st.bias,
                                                 st.factors, s_in), 10)}

        def conv_work(out):
            return (q12.numel() + w4.numel() + 8 * 64 + out.numel(),
                    2 * out.numel() * w4[0].numel(), "int8")
        check("conv_int8", "stem4", lambda: conv2d_int8(
            q12, w4, st.bias, st.factors, padding=pad, relu=True),
            lambda: conv2d_int8_plain(q12, w4, st.bias, st.factors,
                                      padding=pad, relu=True),
            f"x{list(q12.shape)} k4 s1 O64 pad((2,1),(2,1))", conv_work,
            timed=False)
    paths_since(_kernels, "conv_int8", k2_before, "mma_sync",
                "the s2d stem's 4x4 conv")
    s2d_ms = parts["K6"] + parts["K2 4x4"] + parts["max pool"]
    print(f"s2d stem at batch {BATCH}: equal to K1 bit for bit; "
          + ", ".join(f"{n} {v:.4f} ms" for n, v in parts.items())
          + f"; the three parts {s2d_ms:.4f} ms against K1 "
          f"{parts['K1']:.4f} ms  ({label})")

    # ---- 20. the space-to-depth route served ---------------------------
    rengine = InferenceEngine(model, device="cuda", stem_fused=False)
    rresults, rlaunches = served_launches(
        _kernels, lambda: [rengine.run_inference(xb) for xb in batches],
        ["stem_pack", "conv_int8", "matmul_int8"],
        f"ResNet-18 on the s2d stem route, {len(batches)} batches of "
        f"{BATCH}", {"matmul_int8": "wgmma_tma",
                     "conv_int8": {"mma_sync": len(batches),
                                   "wgmma_tma": 19 * len(batches)}})
    if rlaunches["stem_fused"] != 0 or rlaunches["stem_pack"] != len(
            batches):
        fail(f"the s2d route launched K1 {rlaunches['stem_fused']} and K6 "
             f"{rlaunches['stem_pack']} times")
    with torch.inference_mode():
        for b, (xb, res) in enumerate(zip(batches, rresults)):
            if res.logits.shape != (BATCH, CLASSES) or \
                    not np.isfinite(res.logits).all():
                fail(f"s2d route batch {b}: logits {res.logits.shape} not "
                     f"finite")
            xt = torch.from_numpy(xb).to(dev)
            for what, ref in (
                    ("the plain path", rengine.module.forward_plain(xt)),
                    ("the default (K1) route", mod(xt))):
                if not np.array_equal(res.logits, ref.cpu().numpy()):
                    fail(f"s2d route batch {b}: logits differ from {what}")
        cpu = ResNet18Int8Module(model, "cpu", stem_fused=False)(
            torch.from_numpy(batches[0][:2])).numpy()
        if not np.array_equal(rresults[0].logits[:2], cpu):
            fail("s2d route logits differ from the plain path on the CPU")
        x100 = torch.from_numpy(batches[1][:100]).to(dev)
        q0 = quantize_input(x0, s_in)
        _kernels.reset_launch_counts()
        odd, q_route = rengine.module(x100), rengine.module(q0)
        torch.cuda.synchronize()
        c = _kernels.launch_counts()
        if c["stem_pack"] != 1 or c["stem_fused"] or c["stem_int8"]:
            fail(f"batch 100 and int8 input on the route launched {c}")
        if not (torch.equal(odd, mod(x100)) and torch.equal(q_route, mod(q0))
                and torch.equal(q_route, mod(x0))):
            fail("the route's batch of 100 or its int8 batch differs from "
                 "the default route")
    print(f"s2d route logits: {len(batches)} x [{BATCH}, {CLASSES}] finite, "
          f"bit-identical to the plain path on the card, to the default "
          f"(K1) route and (2 images) on the CPU; a batch of 100 and an "
          f"int8 batch (space_to_depth_nchw -> K2) equal the default route")
    dengine = InferenceEngine(model, device="cuda")
    for eng, what in ((dengine, "default (K1)"), (rengine, "s2d (K6, K2)"),
                      (rengine, "s2d (K6, K2)"), (dengine, "default (K1)")):
        bench = eng.benchmark(batches[0], iters=10)
        print(f"ResNet-18 {what:13s} stem, forward batch {BATCH}: "
              f"{bench.latency_s * 1e3:.3f} ms median, "
              f"{bench.images_per_s:.1f} img/s  ({label})")
    print(f"s2d route run_inference incl. copies: "
          f"{[round(r.images_per_s, 1) for r in rresults]} img/s  ({label})")
    del rengine, dengine

    # ---- 21. K4 at the reference's 14 x 14 blocks -----------------------
    from resnet_accel_tpu_torch.sparse import effective_density, regroup_bsr

    def regrouped(A, bsr, want, name, **kw):
        """K4 on ``bsr`` regrouped to 128 x 128 (the JAX package's recipe
        for 14 x 14 exports), bit for bit against the 14 x 14 path's
        output ``want``: (the packed weight, its time, its path)."""
        pk128 = pack_bsr(regroup_bsr(bsr), dev)
        if not torch.equal(bsr_matmul_wt(A, pk128, **kw), want):
            fail(f"K4 on the regrouped {name} != the 14 x 14 path")
        return (pk128, time_ms(lambda: bsr_matmul_wt(A, pk128, **kw), 10),
                plan_text(bsr_plan(A, pk128, n_sms)))

    with tempfile.TemporaryDirectory() as tmp14:
        mnist_int8_dir(tmp14, SEED)
        mnist14 = MNISTCNNInt8.from_int8_dir(tmp14, digits).with_fc1_bsr(14)
    print(f"MNIST CNN at 14 x 14: fc1 {mnist14.fc1_bsr.nnz_blocks}/"
          f"{mnist14.fc1_bsr.total_blocks} blocks stored, sparsity "
          f"{mnist14.sparsity_report()}")
    m14engine = InferenceEngine(mnist14, device="cuda")
    mm14 = m14engine.module
    with torch.inference_mode():
        xt = torch.from_numpy(xm).to(dev)
        f = torch.nn.functional.pad(quantize_input(xt, mm14.s_input),
                                    (0, 0, 0, 0, 0, 3))
        f = conv2d_int8(f.contiguous(memory_format=cl), mm14.conv1_w,
                        mm14.conv1_b, mm14.conv1_f, relu=True)
        f = conv2d_int8(f, mm14.conv2_w, mm14.conv2_b, mm14.conv2_f,
                        relu=True)
        f = maxpool2d_int8(f, 2, 2).contiguous().reshape(BATCH, -1)
        kw = dict(bias=mm14.fc1_b, factors=mm14.fc1_f, relu=True)
        pk = mm14.fc1_packed
        check("bsr_matmul", "fc1@14",
              lambda: bsr_matmul_wt(f, pk, **kw),
              lambda: bsr_matmul_wt_plain(f, pk, **kw),
              f"A{list(f.shape)} N{pk.n_out} "
              f"{pk.nnz_source}/{pk.total_source} blocks 14x14",
              lambda out: bsr_work(f, pk, out),
              library=int_mm_call(f, densify(pk)), timed=False,
              plan=bsr_plan(f, pk, n_sms))
        pk128, ms128, path128 = regrouped(f, mnist14.fc1_bsr,
                                          bsr_matmul_wt(f, pk, **kw),
                                          "fc1", **kw)
        print(f"bsr_matmul   fc1@14 regrouped to 128x128: "
              f"{pk128.nnz_source}/{pk128.total_source} blocks "
              f"(effective_density "
              f"{effective_density(mnist14.fc1_bsr, 128, 128):.3f}), equal, "
              f"{ms128:.4f} ms {path128}  ({label})")
        # the same A at a base 8 bytes off 16: TMA refuses it, so the call
        # takes mma_sync, K4's path for such A, K % 16 != 0 and wide blocks
        fu = torch.empty(f.numel() + 8, dtype=torch.int8,
                         device=dev)[8:].view(f.shape)
        fu.copy_(f)
        before = dict(_kernels.KERNELS["bsr_matmul"].variants)
        check("bsr_matmul", "fc1@14u",
              lambda: bsr_matmul_wt(fu, pk, **kw),
              lambda: bsr_matmul_wt_plain(fu, pk, **kw),
              f"A{list(fu.shape)} off 16 B, 14x14",
              lambda out: bsr_work(fu, pk, out), timed=False,
              plan=bsr_plan(fu, pk, n_sms))
        paths_since(_kernels, "bsr_matmul", before, "mma_sync",
                    "K4 on the MNIST fc1 at 14 x 14, A off 16 bytes")
        if not torch.equal(bsr_matmul_wt(fu, pk, **kw),
                           bsr_matmul_wt(f, pk, **kw)):
            fail("K4 on mma_sync != wgmma_small at the MNIST fc1")
    m14res, m14launches = served_launches(
        _kernels, lambda: m14engine.run_inference(xm),
        ["conv_int8", "matmul_int8", "bsr_matmul"],
        f"MNIST CNN with fc1 at 14 x 14, a batch of {BATCH}",
        {"matmul_int8": "wgmma_tma", "bsr_matmul": "wgmma_small",
         "conv_int8": {"mma_sync": 1, "wgmma_tma": 1}})
    with torch.inference_mode():
        plain = mm14.forward_plain(torch.from_numpy(xm).to(dev)).cpu().numpy()
        cpu = MNISTCNNInt8Module(mnist14, "cpu")(torch.from_numpy(xm)).numpy()
    if not (np.array_equal(m14res.logits, plain)
            and np.array_equal(m14res.logits, cpu)
            and np.array_equal(m14res.logits, mres.logits)):
        fail("MNIST logits at 14 x 14 differ from the plain path or the "
             "128 x 128 model")
    print(f"MNIST logits at 14 x 14 bit-identical to the plain path on the "
          f"card, on the CPU and to the 128 x 128 model's")

    from resnet_accel_tpu_torch.sparse import build_bsr_int8_direct
    g_rng = np.random.default_rng(SEED + 3)
    W = g_rng.integers(-128, 128, (2048, 2048)).astype(np.int8)
    A = torch.from_numpy(g_rng.integers(-128, 128, (512, 2048)).astype(
        np.int8)).to(dev)
    with torch.inference_mode():
        for blk in (14, 128):
            nb = -(-2048 // blk)
            keep = np.repeat(np.repeat(g_rng.random((nb, nb)) >= SPARSITY,
                                       blk, 0), blk, 1)[:2048, :2048]
            bsr = build_bsr_int8_direct(W * keep, blk)
            pk = pack_bsr(bsr, dev)
            check("bsr_matmul", f"gemm{blk}",
                  lambda: bsr_matmul_wt(A, pk), lambda: bsr_matmul_wt_plain(
                      A, pk), f"A[512, 2048] N2048 {pk.nnz_source}/"
                  f"{pk.total_source} blocks {blk}x{blk}",
                  lambda out: bsr_work(A, pk, out),
                  library=int_mm_call(A, densify(pk)), timed=False,
                  plan=bsr_plan(A, pk, n_sms))
            if not torch.equal(bsr_matmul_wt(A, pk).cpu().to(torch.int64),
                               A.cpu().to(torch.int64) @ torch.from_numpy(
                                   W * keep).to(torch.int64).t()):
                fail(f"K4 at {blk} x {blk} differs from the dense product")
            if blk == 14:
                pk128, ms128, path128 = regrouped(
                    A, bsr, bsr_matmul_wt(A, pk), "2048 GEMM")
                print(f"bsr_matmul   gemm14 regrouped to 128x128: "
                      f"{pk128.nnz_source}/{pk128.total_source} blocks "
                      f"(effective_density "
                      f"{effective_density(bsr, 128, 128):.3f}), equal, "
                      f"{ms128:.4f} ms {path128}  ({label})")

    t0 = time.perf_counter()
    calib_img = np.random.default_rng(SEED).normal(
        0, 1, (2, 3, HW, HW)).astype(np.float32)   # the calibration above
    pruned14 = quantize_resnet18(
        prune_params_blockwise(params, sparsity=SPARSITY, block=14),
        calib_img, CLASSES)
    sparse14 = attach_bsr(pruned14, block=14, min_sparsity=0.25)
    n14 = sum(qc.bsr is not None for _, qc in sparse14.named_convs())
    print(f"prune {SPARSITY} at 14, quantize, attach BSR on the CPU: "
          f"{time.perf_counter() - t0:.1f} s; {n14} sparse convs")
    x8 = x0[:8]
    bsr14 = {name: qc.bsr for name, qc in sparse14.named_convs()
             if qc.bsr is not None}

    def k4_walk(model_, what, regroup=None):
        """K4 against its plain version at each sparse conv of a batch of
        8; the summed K4, plain, bound and ``_int_mm`` times, and with
        ``regroup`` (each conv's BSR by name) the weights regrouped to 128
        x 128's."""
        m = ResNet18Int8Module(model_, dev).eval()
        tot = plain_tot = bound_tot = lib_tot = reg_tot = 0.0
        with torch.inference_mode():
            a = stem_conv_pool(x8, m.stem_k1_w, m.stem.bias,
                               m.stem.factors, m.s_input)
            for i, (convs, rs) in enumerate(zip(m.blocks, m.res_scales)):
                def run(tag, inp, **join):
                    nonlocal tot, plain_tot, bound_tot, lib_tot, reg_tot
                    cv = convs[tag]
                    if cv.packed is not None:
                        A = im2col_nchw(inp, cv.kernel, cv.stride,
                                        cv.padding).reshape(
                            -1, inp.shape[1] * cv.kernel ** 2)
                        pk = cv.packed
                        kw = dict(bias=cv.bias, factors=cv.factors,
                                  relu=cv.relu)
                        check("bsr_matmul", f"b{i}.{tag}",
                              lambda: bsr_matmul_wt(A, pk, **kw),
                              lambda: bsr_matmul_wt_plain(A, pk, **kw),
                              f"A{list(A.shape)} {pk.nnz_source}/"
                              f"{pk.total_source} blocks {what}",
                              lambda out: bsr_work(A, pk, out),
                              library=int_mm_call(A, densify(pk)),
                              timed=False, plan=bsr_plan(A, pk, n_sms))
                        tot += last_check["ms"]
                        plain_tot += last_check["plain_ms"]
                        bound_tot += last_check["bound_ms"]
                        lib_tot += last_check["library_ms"] or 0.0
                        if regroup is not None:
                            reg_tot += regrouped(
                                A, regroup[f"b{i}.{tag}"],
                                bsr_matmul_wt(A, pk, **kw), f"b{i}.{tag}",
                                **kw)[1]
                    return cv(inp, conv2d_int8, bsr_matmul_wt, **join)
                y = run("c1", a)
                r = run("ds", a) if "ds" in convs else a
                a = run("c2", y, residual=r, res_scales=rs)
        return tot, plain_tot, bound_tot, lib_tot, reg_tot
    k4_14, k4_14p, k4_14b, k4_14l, k4_14r = k4_walk(sparse14, "14x14",
                                                    bsr14)
    k4_128, _, k4_128b, k4_128l, _ = k4_walk(sparse, "128x128")
    print(f"K4 over the sparse ResNet-18's convs at batch 8: 14 x 14 "
          f"{k4_14:.4f} ms (plain {k4_14p:.4f}, bound {k4_14b:.4f}, "
          f"_int_mm on the densified weight {k4_14l:.4f}, regrouped to "
          f"128 x 128 {k4_14r:.4f}), 128 x 128 "
          f"{k4_128:.4f} ms (bound {k4_128b:.4f}, _int_mm {k4_128l:.4f}); "
          f"at batch {BATCH}, 128 x 128: {s4['ms']:.4f} ms  ({label})")
    s14engine = InferenceEngine(sparse14, device="cuda")
    x8np = batches[0][:8]
    s14res, s14launches = served_launches(
        _kernels, lambda: s14engine.run_inference(x8np),
        ["stem_fused", "matmul_int8", "bsr_matmul"],   # every conv is sparse
        "sparse ResNet-18 at 14 x 14, a batch of 8",
        {"matmul_int8": "wgmma_tma", "bsr_matmul": "wgmma_small"})
    with torch.inference_mode():
        for what, ref in (
                ("the plain path", s14engine.module.forward_plain(x8)),
                ("the dense forward of the pruned model",
                 ResNet18Int8Module(pruned14, dev)(x8))):
            if s14res.logits.shape != (8, CLASSES) or not np.array_equal(
                    s14res.logits, ref.cpu().numpy()):
                fail(f"sparse 14 x 14 logits differ from {what}")
    print("sparse ResNet-18 at 14 x 14: logits [8, 1000] bit-identical to "
          "the plain path and to the dense forward of the pruned model")
    del m14engine

    # the 14 x 14 model at batch 128: each conv against _int_mm and the
    # regroup recipe, then the served forward
    m14 = s14engine.module
    t128 = {"k4": 0.0, "int_mm": 0.0, "regroup": 0.0, "bound": 0.0}
    with torch.inference_mode():
        a = stem_conv_pool(x0, m14.stem_k1_w, m14.stem.bias,
                           m14.stem.factors, m14.s_input)
        for i, (convs, rs) in enumerate(zip(m14.blocks, m14.res_scales)):
            def run128(tag, inp, **join):
                cv = convs[tag]
                if cv.packed is None:
                    fail(f"b{i}.{tag} carries no BSR at 14 x 14")
                A = im2col_nchw(inp, cv.kernel, cv.stride,
                                cv.padding).reshape(
                    -1, inp.shape[1] * cv.kernel ** 2)
                pk, name = cv.packed, f"b{i}.{tag}"
                lib = int_mm_call(A, densify(pk))
                if lib is None:
                    fail(f"_int_mm does not take {name}'s shape")
                got, want = bsr_matmul_wt(A, pk), lib()
                if not torch.equal(got, want):
                    fail(f"K4 at 14 x 14, batch {BATCH}, {name}: != _int_mm")
                pk128, ms128, _ = regrouped(A, bsr14[name], got, name)
                times = (time_ms(lambda: bsr_matmul_wt(A, pk), 10),
                         time_ms(lib, 10), ms128)
                b_ms, o_ms = bound_ms(*bsr_work(A, pk, got))
                for key, ms in zip(("k4", "int_mm", "regroup", "bound"),
                                   times + (max(b_ms, o_ms),)):
                    t128[key] += ms
                print(f"bsr_matmul   {name:6s} A{list(A.shape)} "
                      f"{pk.nnz_source}/{pk.total_source} blocks 14x14 "
                      f"int32 equal to _int_mm: K4 {times[0]:.4f} ms "
                      f"{plan_text(bsr_plan(A, pk, n_sms))}  _int_mm "
                      f"{times[1]:.4f} ms  regrouped to 128x128 "
                      f"{pk128.nnz_source}/{pk128.total_source} blocks "
                      f"(effective_density "
                      f"{effective_density(bsr14[name], 128, 128):.3f}, "
                      f"equal) {times[2]:.4f} ms  bound "
                      f"{max(b_ms, o_ms):.4f} ms  ({label})")
                return cv(inp, conv2d_int8, bsr_matmul_wt, **join)
            y = run128("c1", a)
            r = run128("ds", a) if "ds" in convs else a
            a = run128("c2", y, residual=r, res_scales=rs)
    print(f"K4 over the 14 x 14 ResNet-18's {len(bsr14)} convs at batch "
          f"{BATCH}: {t128['k4']:.4f} ms (bound {t128['bound']:.4f}); "
          f"_int_mm on the densified weights {t128['int_mm']:.4f} ms; the "
          f"weights regrouped to 128 x 128 on K4's Hopper path "
          f"{t128['regroup']:.4f} ms  ({label})")
    s128res, s128launches = served_launches(
        _kernels, lambda: [s14engine.run_inference(xb) for xb in batches],
        ["stem_fused", "matmul_int8", "bsr_matmul"],
        f"sparse ResNet-18 at 14 x 14, {len(batches)} batches of {BATCH}",
        {"matmul_int8": "wgmma_tma", "bsr_matmul": "wgmma_small"})
    d14engine = InferenceEngine(pruned14, device="cuda")
    with torch.inference_mode():
        for b, (xb, res) in enumerate(zip(batches, s128res)):
            ref = d14engine.module(torch.from_numpy(xb).to(dev)).cpu()
            if res.logits.shape != (BATCH, CLASSES) or not np.array_equal(
                    res.logits, ref.numpy()):
                fail(f"sparse 14 x 14 batch {b} of {BATCH}: logits differ "
                     f"from the dense forward of the pruned model")
    print(f"sparse ResNet-18 at 14 x 14: {len(batches)} x [{BATCH}, "
          f"{CLASSES}] logits bit-identical to the dense forward of the "
          f"pruned model")
    for eng, what in ((d14engine, "dense"), (s14engine, "sparse"),
                      (s14engine, "sparse"), (d14engine, "dense")):
        bench = eng.benchmark(batches[0], iters=10)
        print(f"pruned at 14 x 14, {what:6s} forward batch {BATCH}: "
              f"{bench.latency_s * 1e3:.3f} ms median, "
              f"{bench.images_per_s:.1f} img/s  ({label})")
    del s14engine, d14engine

    # ---- 22. K8 at block_c 16, block_o 14 --------------------------------
    k_rng = np.random.default_rng(SEED + 4)
    k8_before = dict(_kernels.KERNELS["sparse_conv"].variants)
    with torch.inference_mode():
        for name, C, O, Hs, k, s, p in cli.CONV_CASES:
            if name.split()[0] not in ("l3.c1", "l4.ds"):
                continue
            xs = torch.from_numpy(k_rng.integers(
                -128, 128, (SWEEP_BATCH, C, Hs, Hs)).astype(np.int8)).to(
                dev).contiguous(memory_format=cl)
            w = tap_sparse_weight(k_rng, O, C, k, SWEEP_SPARSITY,
                                  block_o=14, block_c=16)
            fct = torch.full((O,), 0.001, dtype=torch.float32, device=dev)
            zero = torch.zeros(O, dtype=torch.int32, device=dev)
            pk = device_pack(pack_conv_bsr(w, padding=p, block_o=14,
                                           block_c=16), dev)
            kw = dict(factors=fct, relu=True, stride=s)
            got = check("sparse_conv", name.split()[0],
                        lambda: sparse_conv2d_int8(xs, pk, **kw),
                        lambda: sparse_conv2d_int8_plain(xs, pk, **kw),
                        f"x{list(xs.shape)} k{k} s{s} O{O} "
                        f"{pk.nnz_source}/{pk.total_source} blocks 16x14",
                        lambda out: sconv_work(xs, pk, s, out), timed=False)
            wd = pack_weight(w.reshape(O, -1), C, k, dev)
            if not torch.equal(got, conv2d_int8(xs, wd, zero, fct, stride=s,
                                                padding=p, relu=True)):
                fail(f"K8 at 16 x 14 and the dense K2 disagree at {name}")
            print(f"{'':12s} {name}: K8 at 16 x 14 {last_check['ms']:.4f} ms "
                  f"equal to the dense K2; at 128 x 128 "
                  f"{k8_case_ms[name]:.4f} ms  ({label})")
    paths_since(_kernels, "sparse_conv", k8_before, "mma_sync",
                "K8 at 16 x 14")

    # ---- 23. the probes ----------------------------------------------------
    with torch.inference_mode():
        for M, K in ((64, 192), (128, 192), (64, 576), (128, 576)):
            r = probes.mma_s8_rate(M, K, dev, time_ms)
            print(f"probe mma_s8_rate M {M} N {probes.MMA_N} K {K}: "
                  f"{r['tops']:.1f} TOP/s ({100 * r['tops'] / 1979:.1f} % "
                  f"of 1,979), {r['ns_per_dot']:.1f} ns a tile product "
                  f"over {r['blocks']} blocks  ({label})")
        for kind in probes.CHAIN_KINDS:
            r = probes.chain_rate(kind, dev, time_ms)
            print(f"probe chain_rate {kind}: {r['steps_per_s'] / 1e12:.3f} "
                  f"T steps/s over {r['threads']} threads  ({label})")
        # the stem's tensor-core tile (stem_mma_tile.cuh), pooled on K1's
        # fp32 input: whole, equal to K1's output; timed beside K1 and K10
        stem_args = (x0, mod.stem_k1_w, st.bias, st.factors, s_in)
        if not torch.equal(probes.stem_ablation(*stem_args, "full"), k1):
            fail("the stem tile probe with no stage knocked out differs "
                 "from K1")
        k1_ms = time_ms(lambda: stem_conv_pool(*stem_args), 10)
        k10_pool_ms = time_ms(lambda: stem_conv_pool_int8(
            q0, mod.stem_k1_w, st.bias, st.factors, pool=True), 10)
        abl = {mode: time_ms(lambda: probes.stem_ablation(*stem_args, mode),
                             10) for mode in probes.STEM_MODES}
        for mode, ms in abl.items():
            print(f"probe stem mma tile {mode:10s}: {ms:.4f} ms at batch "
                  f"{BATCH}, fp32 input (K1 {k1_ms:.4f} ms, K10 pooled "
                  f"{k10_pool_ms:.4f} ms)  ({label})")
        a_box = torch.from_numpy(np.random.default_rng(SEED + 5).integers(
            -128, 128, (300, 64)).astype(np.int8)).to(dev)
        for xk in (0, 16, 48):
            if not torch.equal(probes.tma_box(a_box, xk),
                               probes.tma_box_plain(a_box, xk)):
                fail(f"probe tma_box at x = {xk} != its plain version")
    probe = subprocess.run(
        [sys.executable, "-c",
         "import sys, torch; sys.path.insert(0, sys.argv[1]); "
         "from resnet_accel_tpu_torch import probes; "
         "probes.tma_box(torch.zeros((300, 64), dtype=torch.int8, "
         "device='cuda'), 14); torch.cuda.synchronize()", repo],
        capture_output=True, text=True, timeout=300)
    if probe.returncode == 0 or "illegal instruction" not in probe.stderr:
        fail(f"probe tma_box at x = 14: expected an illegal instruction, got "
             f"exit {probe.returncode}: {probe.stderr[-300:]}")
    print(f"probe tma_box: 16 x 128 boxes at x = 0, 16, 48 equal the plain "
          f"version; at x = 14 the load faults (illegal instruction, in a "
          f"process of its own)  ({label})")
    print(f"stem mma tile split at batch {BATCH} (K1's instantiation): "
          f"input loads (full - no_loads) "
          f"{abl['full'] - abl['no_loads']:.4f} ms, GEMM + epilogue + pool "
          f"(full - stage_only) {abl['full'] - abl['stage_only']:.4f} ms, "
          f"conv tile + pool over the unpooled epilogue (full - no_pool) "
          f"{abl['full'] - abl['no_pool']:.4f} ms, staging alone "
          f"{abl['stage_only']:.4f} ms  ({label})")

    # ---- 24. the native stream ---------------------------------------------
    t0 = time.perf_counter()
    try:
        native.lib()
    except (RuntimeError, OSError) as e:
        fail(f"the native host library did not build: {e}")
    print(f"native host library (g++, native/src): built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    u8 = np.random.default_rng(SEED + 24).integers(
        0, 256, (3 * BATCH, HW, HW, 3), dtype=np.uint8)
    chw = np.ascontiguousarray(u8.transpose(0, 3, 1, 2))
    pre = preprocess_imagenet(u8)
    u8_labels = np.arange(3 * BATCH, dtype=np.int32) % CLASSES
    n_threads, depth = os.cpu_count(), 4

    def native_loader(labels=None):
        return native.BatchLoader(chw, labels, BATCH, IMAGENET_MEAN,
                                  IMAGENET_STD, model.s_input, shuffle=False,
                                  n_threads=n_threads, depth=depth)

    neng = InferenceEngine(model, device="cuda")
    with native_loader(u8_labels) as ld:
        nres, nlaunches = served_launches(
            _kernels, lambda: neng.stream(ld, 3),
            ["stem_int8", "conv_int8", "matmul_int8"],
            f"native int8 stream, 3 batches of {BATCH}",
            {"matmul_int8": "wgmma_tma", "conv_int8": {"wgmma_tma": 19 * 3}})
    if nlaunches["stem_fused"] != 0:
        fail("the native int8 stream launched K1")
    if not np.array_equal(nres.labels, u8_labels):
        fail("the native stream's labels differ from the images' labels")
    qres = neng.stream(QuantizingLoader(pre, model.s_input, BATCH), 3)
    if not np.array_equal(nres.logits, qres.logits):
        fail("the native stream's logits differ from the QuantizingLoader "
             f"stream's (max |err| {np.abs(nres.logits - qres.logits).max()})")
    with torch.inference_mode():
        for b in range(3):
            got = nres.logits[b * BATCH:(b + 1) * BATCH]
            if got.shape != (BATCH, CLASSES) or not np.isfinite(got).all():
                fail(f"native stream batch {b}: logits {got.shape} not "
                     f"finite")
            qb = quantize_input(torch.from_numpy(
                pre[b * BATCH:(b + 1) * BATCH]).to(dev), model.s_input)
            if not np.array_equal(got, mod.forward_plain(qb).cpu().numpy()):
                fail(f"native stream batch {b}: logits differ from the plain "
                     f"path")
    print(f"native stream logits: 3 x [{BATCH}, {CLASSES}] finite, "
          f"bit-identical to the QuantizingLoader stream of "
          f"preprocess_imagenet and to the plain path on the card")
    rates = []
    for kind in ("Q", "N", "N", "Q"):
        if kind == "Q":
            r = neng.stream(QuantizingLoader(pre, model.s_input, BATCH), 12)
        else:
            with native_loader() as ld:
                r = neng.stream(ld, 12)
        rates.append(f"{kind} {r.images_per_s:.1f}")
    print(f"int8 stream img/s over batches 2-12 (CUDA events), in the order "
          f"QuantizingLoader (Q), native (N), N, Q: {', '.join(rates)}; "
          f"os.cpu_count() {os.cpu_count()}, native n_threads {n_threads}, "
          f"depth {depth}  ({label})")
    staging = torch.empty((BATCH, 3, HW, HW), dtype=torch.float32,
                          pin_memory=True)

    def upload_ms(fn):
        times = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def pageable():
        return torch.from_numpy(batches[0]).to(dev)

    def pinned():
        staging.copy_(torch.from_numpy(batches[0]))
        return staging.to(dev, non_blocking=True)
    pageable(), pinned()
    up = [upload_ms(f) for f in (pageable, pinned, pinned, pageable)]
    served = [round(neng.run_inference(xb).images_per_s, 1)
              for xb in batches]
    print(f"run_inference upload of [{BATCH}, 3, {HW}, {HW}] fp32 (host "
          f"clock to a synchronize, median of 10), in the order pageable, "
          f"pinned, pinned, pageable: {up[0]:.3f}, {up[1]:.3f}, {up[2]:.3f}, "
          f"{up[3]:.3f} ms (the engine stages through pinned memory); "
          f"run_inference {served} img/s  ({label})")
    del neng, staging

    # ---- 25. profile and profile --measured --------------------------------
    for depth_, m in ((18, model), (50, model50)):
        peng = InferenceEngine(m, device="cuda")
        table = peng.profile(batches[0], iters=10)
        fwd_s = peng.profiler.summary()["total_latency_s"]
        print(f"ResNet-{depth_} profile, batch {BATCH}: the forward's "
              f"{fwd_s * 1e3:.4f} ms (CUDA events, median of 10) over the "
              f"roofline rows  ({label})\n{table}")
        rows = profile_resnet18(m, batch=BATCH).records
        agg, _ = xprof.profile_layers(peng.module, x0)
        print(f"ResNet-{depth_} profile --measured, batch {BATCH}: device "
              f"time by scope (torch.profiler), roofline bound beside "
              f"({label})\n"
              + xprof.layer_table(agg, {r.name: r.latency_s for r in rows}))
        for name in [r.name for r in rows] + ["pool"]:
            if not agg.get(name, 0.0) > 0:
                fail(f"ResNet-{depth_}: scope {name} has no device time")
        unattr = agg.get(xprof.UNATTRIBUTED, 0.0)
        scoped = sum(agg.values()) - unattr
        # The scopes hold device time of a forward the host had queued
        # ahead of the card (``capture``'s lead spins); the profile's
        # forward is paced by the host's launches.  Held against the
        # forward timed the scopes' way, behind a spin.
        with torch.inference_mode():
            dev_s = time_ms(lambda: peng.module(x0), 10,
                            spin=FORWARD_SPIN_CYCLES) / 1e3
        print(f"ResNet-{depth_}: scopes sum {scoped * 1e3:.4f} ms, "
              f"{100 * scoped / dev_s:.1f} % of the forward's device time "
              f"{dev_s * 1e3:.4f} ms (CUDA events behind a spin, median of "
              f"10); the host-paced forward {fwd_s * 1e3:.4f} ms, the card "
              f"idle {100 * max(0.0, 1 - dev_s / fwd_s):.1f} % of it; "
              f"unattributed device time {unattr * 1e3:.4f} ms  ({label})")
        if abs(scoped - dev_s) > 0.10 * dev_s:
            fail(f"ResNet-{depth_}: the scopes sum to {scoped * 1e3:.4f} ms, "
                 f"not within 10 % of the forward's device time "
                 f"{dev_s * 1e3:.4f}")
        if scoped > 1.10 * fwd_s:
            fail(f"ResNet-{depth_}: the scopes sum to {scoped * 1e3:.4f} ms, "
                 f"over the host-paced forward's {fwd_s * 1e3:.4f}")
        if unattr > 0.05 * fwd_s:
            fail(f"ResNet-{depth_}: {unattr * 1e3:.4f} ms of device time "
                 f"reached no scope")
        del peng
    for args in (["--batch", "128"],
                 ["--measured", "--depth", "50", "--batch", "128"]):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "resnet_accel_tpu_torch", "profile",
             *args, "--device", "cuda"], cwd=repo, capture_output=True,
            text=True, timeout=600)
        print(proc.stdout, end="")
        print(f"profile {' '.join(args)}: {time.perf_counter() - t0:.1f} s"
              f"  ({label})")
        if proc.returncode != 0 or "TOTAL" not in proc.stdout:
            print(proc.stderr, file=sys.stderr)
            fail(f"CLI profile {' '.join(args)} exited {proc.returncode}")

    # ---- 26. power ---------------------------------------------------------
    fwd_ops = sum(r.total_ops for r in profile_resnet18(
        model, batch=BATCH).records)
    with torch.inference_mode():
        mod(x0)
        torch.cuda.synchronize()
        n_fwd = 0
        with power.PowerSampler(dev.index) as ps:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 2.5:
                for _ in range(20):
                    mod(x0)
                n_fwd += 20
            torch.cuda.synchronize()
    live = ps.profile(f"ResNet-18 forward x {n_fwd}, batch {BATCH}",
                      total_ops=fwd_ops * n_fwd)
    if live.modeled or len(ps.watts) < 2:
        fail(f"no live power profile ({len(ps.watts)} samples)")
    smi = telemetry["nvidia_smi"]
    util = fwd_ops * n_fwd / live.duration_s / 1979e12
    modeled = power.estimate_power("modeled", live.duration_s,
                                   fwd_ops * n_fwd, util, smi["power_limit_w"],
                                   smi["idle_w"])
    print(f"power: {live.report()}; {len(ps.watts)} samples of {ps.field} "
          f"over {live.duration_s:.2f} s, average {live.avg_w:.2f} W, peak "
          f"{live.peak_w:.2f} W, SM clock {ps.avg_sm_mhz:.0f} MHz average "
          f"({min(ps.sm_mhz):.0f}-{max(ps.sm_mhz):.0f}), "
          f"{live.gops_per_w:.1f} GOPS/W; idle before any load "
          f"{smi['idle_w']:.2f} W; modeled at {100 * util:.1f} % of the int8 "
          f"peak: {modeled.avg_w:.1f} W  ({label})")

    # ---- 27. the typed errors ----------------------------------------------
    eeng = InferenceEngine(model, device="cuda")
    teng = InferenceEngine(model, device="cuda", timeout_s=0.0)
    for what, call, code in (
            ("a 3-D input", lambda: eeng.run_inference(batches[0][0]),
             AccelErrorCode.INVALID_CONFIG),
            ("n_batches=0", lambda: eeng.stream(
                QuantizingLoader(pre, model.s_input, BATCH), 0),
             AccelErrorCode.INVALID_CONFIG),
            ("timeout_s=0", lambda: teng.run_inference(batches[0]),
             AccelErrorCode.TIMEOUT)):
        try:
            call()
        except AcceleratorError as e:
            if e.code != code:
                fail(f"{what}: {e.code}, not {code}")
            print(f"typed error on the card, {what}: {e}")
        else:
            fail(f"{what}: no AcceleratorError")
    del eeng, teng

    # ---- 28. the artifact flow -----------------------------------------------
    from resnet_accel_tpu_torch.models.attention import SparseAttentionInt8
    from resnet_accel_tpu_torch.ops import (bsr_matmul_wt_xla,
                                            device_pack_gather,
                                            pack_gather_bsr)
    from resnet_accel_tpu_torch.sparse import (build_bsr_int8_direct,
                                               load_layer_dir, regroup_bsr)
    t28 = time.perf_counter()
    art = tempfile.TemporaryDirectory()

    def at(name):
        return os.path.join(art.name, name)

    def run_cli(*args, rc=0):
        proc = subprocess.run(
            [sys.executable, "-m", "resnet_accel_tpu_torch", *args],
            cwd=repo, capture_output=True, text=True, timeout=600)
        print(proc.stdout, end="")
        if proc.returncode != rc:
            print(proc.stderr, file=sys.stderr)
            fail(f"CLI {args[0]} exited {proc.returncode}, not {rc}")
        return proc.stdout

    # 28.1 quantize a seeded fp32 checkpoint, serve it
    ck_rng = np.random.default_rng(SEED + 28)
    ck = {}
    for layer, shape in MNIST_SHAPES.items():
        fan_in = int(np.prod(shape[1:]))
        ck[f"{layer}.weight"] = ck_rng.normal(
            0, np.sqrt(2.0 / fan_in), shape).astype(np.float32)
        ck[f"{layer}.bias"] = ck_rng.normal(0, 0.05, shape[0]).astype(
            np.float32)
    np.savez(at("ck.npz"), **ck)
    np.save(at("digits.npy"), digits)
    run_cli("quantize", "--checkpoint", at("ck.npz"), "--output", at("q"))
    printed = run_cli("infer", "--model", "mnist", "--weights", at("q"),
                      "--input", at("digits.npy"), "--device", "cuda",
                      "--limit", "8")
    qeng = InferenceEngine(MNISTCNNInt8.from_int8_dir(at("q"), digits),
                           device="cuda")
    qres, alaunches = served_launches(
        _kernels, lambda: qeng.run_inference(xm),
        ["conv_int8", "matmul_int8"],
        f"the quantized MNIST checkpoint, a batch of {BATCH}",
        {"matmul_int8": "wgmma_tma",
         "conv_int8": {"mma_sync": 1, "wgmma_tma": 1}})
    with torch.inference_mode():
        plain = qeng.module.forward_plain(
            torch.from_numpy(xm).to(dev)).cpu().numpy()
    classes = [int(line.split("class ")[1].split()[0])
               for line in printed.splitlines()
               if line.startswith("sample ")]
    if not np.array_equal(qres.logits, plain):
        fail("the quantized checkpoint's logits differ from the plain path")
    if classes != qres.predictions[:8].tolist():
        fail(f"infer printed classes {classes}, the engine "
             f"{qres.predictions[:8].tolist()}")
    print(f"quantize -> infer: logits [{BATCH}, 10] bit-identical to the "
          f"plain path on the card; the CLI's 8 classes the engine's")

    # 28.2 export the quantized fc1 pruned at 14 x 14, simulate it
    w8 = np.load(at("q/fc1_weight_int8.npy"))
    keep = ck_rng.random((-(-w8.shape[0] // 14), -(-w8.shape[1] // 14))) \
        >= MNIST_FC1_SPARSITY
    np.save(at("fc1_14.npy"),
            w8 * np.repeat(np.repeat(keep, 14, 0), 14, 1)[:w8.shape[0],
                                                          :w8.shape[1]])
    run_cli("export", "--weights", at("fc1_14.npy"), "--output", at("fc1"),
            "--name", "fc1", "--block-h", "14", "--block-w", "14")
    run_cli("sim", "--artifact", at("fc1"), "--output", at("g.npy"))

    # 28.3 K4 on the regrouped layer against sim, through verify
    bsr14 = load_layer_dir(at("fc1"))
    pk = pack_bsr(regroup_bsr(bsr14), dev)
    K, N = bsr14.shape[1], bsr14.shape[0]
    golden_out = np.load(at("g.npy"))
    with torch.inference_mode():
        a_sim = torch.from_numpy(
            ((np.arange(bsr14.padded_shape[1]) % 256) - 128).astype(
                np.int8)[None, :K]).to(dev)
        before = dict(_kernels.KERNELS["bsr_matmul"].variants)
        k4_out = np.zeros_like(golden_out)       # the padded N's rows: 0
        k4_out[:, :N] = bsr_matmul_wt(a_sim, pk).cpu().numpy()
        paths_since(_kernels, "bsr_matmul", before, "wgmma_tma",
                    "K4 on the exported fc1 regrouped to 128 x 128")
    np.save(at("k4.npy"), k4_out)
    if "PASS" not in run_cli("verify", "--golden", at("g.npy"), "--actual",
                             at("k4.npy")):
        fail("verify did not PASS K4 against sim")
    k4_out[0, 5] ^= 1
    np.save(at("k4_bad.npy"), k4_out)
    if "FAIL: 1 mismatches" not in run_cli(
            "verify", "--golden", at("g.npy"), "--actual", at("k4_bad.npy"),
            rc=1):
        fail("verify did not FAIL the corrupted copy")

    # 28.4 bench --artifact at M = 1 and 128, K4 through CUDA graphs; the
    # unpruned fc1 too, exported at 14 x 14 (6,590 blocks, the count of the
    # reference's own FC1 artifact)
    run_cli("export", "--weights", at("q/fc1_weight_int8.npy"), "--output",
            at("fc1_dense"), "--name", "fc1", "--block-h", "14",
            "--block-w", "14")
    art_k4 = 0          # K4 launches run by bench --artifact, replays too
    for what, layer_dir, M_ in (("fc1 at 0.9", at("fc1"), 1),
                                ("fc1 at 0.9", at("fc1"), BATCH),
                                ("fc1 unpruned", at("fc1_dense"), 1)):
        case = f"{what}, M {M_}"
        argv = ["bench", "--artifact", layer_dir, "--chain", "256",
                "--device", "cuda", "--batch", str(M_)]
        buf = io.StringIO()
        _kernels.reset_launch_counts()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        counts = _kernels.launch_counts()
        variants = _kernels.variant_counts()
        row = json.loads(buf.getvalue().strip().splitlines()[-1])
        print(f"bench --artifact, {case}: {json.dumps(row)}; launch "
              f"counts (captures counted once): {counts}; variants: "
              f"{variants}  ({label})")
        if rc != 0 or not row["bit_exact"]:
            fail(f"bench --artifact, {case}: rc {rc}, bit_exact "
                 f"{row['bit_exact']}")
        if (counts["bsr_matmul"] != 2 + 256
                or set(variants.get("bsr_matmul", {})) != {"wgmma_tma"}):
            fail(f"bench --artifact, {case}: K4 took {variants}, "
                 f"{counts['bsr_matmul']} launches counted, not 258")
        art_k4 += row["launches"]
        pk_art = pack_bsr(regroup_bsr(load_layer_dir(layer_dir)), dev)
        with torch.inference_mode():
            am = torch.from_numpy(((np.arange(K)[None, :]
                                    + np.arange(M_)[:, None]) % 256
                                   - 128).astype(np.int8)).to(dev)
            a_lib = torch.zeros((max(M_, 32), K), dtype=torch.int8,
                                device=dev)
            a_lib[:M_] = am
            check("bsr_matmul", f"art{M_}",
                  lambda: bsr_matmul_wt(am, pk_art),
                  lambda: bsr_matmul_wt_plain(am, pk_art),
                  f"A{list(am.shape)} N{pk_art.n_out} {pk_art.nnz_source}/"
                  f"{pk_art.total_source} blocks ({what}, regrouped)",
                  lambda out: bsr_work(am, pk_art, out),
                  library=int_mm_call(a_lib, densify(pk_art)), timed=False,
                  plan=bsr_plan(am, pk_art, n_sms))
        lms = last_check["library_ms"]
        print(f"bench --artifact, {case}: {row['latency_us']:.4f} us a "
              f"call in a CUDA graph of 256 against K4 alone "
              f"{last_check['ms'] * 1e3:.4f} us, plain "
              f"{last_check['plain_ms'] * 1e3:.4f} us, bound "
              f"{last_check['bound_ms'] * 1e3:.4f} us, _int_mm at M "
              f"{max(M_, 32)} "
              + ("refused" if lms is None else f"{lms * 1e3:.4f} us")
              + f"; {row['gops']:.3f} GOPS over the layer's "
              f"{row['nnz_blocks']} 14 x 14 blocks  ({label})")

    # 28.5 the fixture tree, sparse attention on the card
    run_cli("fixtures", "--output", at("fx"), "--seed", "42")
    att_rng = np.random.default_rng(SEED + 30)
    for sp in ("80pct", "90pct"):
        root = at(f"fx/transformer/{sp}")
        att = SparseAttentionInt8.from_fixture_root(root, device="cuda")
        att_cpu = SparseAttentionInt8.from_fixture_root(root, device="cpu")
        for T in (8, 640):
            xa = att_rng.normal(0, 1, (T, att.q.d_in)).astype(np.float32)
            with torch.inference_mode():
                got = att(xa).cpu().numpy()
                cpu = att_cpu(xa).numpy()
            gold = att.forward_golden(xa)
            ok = (got.shape == (T, att.q.d_out) and np.isfinite(got).all()
                  and np.allclose(got, gold, rtol=2e-4, atol=2e-5)
                  and np.allclose(got, cpu, rtol=2e-4, atol=2e-5))
            print(f"SparseAttentionInt8 {sp} T {T}: {got.shape}, max |card "
                  f"- golden| {np.abs(got - gold).max():.3g}, max |card - "
                  f"cpu| {np.abs(got - cpu).max():.3g}, within rtol 2e-4 "
                  f"atol 2e-5: {ok}; sparsity {att.sparsity_report()}")
            if not ok:
                fail(f"SparseAttentionInt8 {sp} at T {T} off the golden "
                     f"or the CPU")

    # 28.6 the gather pack on the card against the host pack
    g_rng = np.random.default_rng(SEED + 31)
    W2k = g_rng.integers(-128, 128, (2048, 2048)).astype(np.int8)
    W2k *= np.repeat(np.repeat(g_rng.random((16, 16)) >= SPARSITY, 128, 0),
                     128, 1).astype(np.int8)
    with torch.inference_mode():
        for name, wn, blk, an in (
                ("2048 GEMM, 128 x 128 at 0.7", W2k, 128,
                 g_rng.integers(-128, 128, (512, 2048)).astype(np.int8)),
                ("fc1, 14 x 14 at 0.9", np.load(at("fc1_14.npy")), 14,
                 g_rng.integers(-128, 128, (BATCH, K)).astype(np.int8))):
            wt = torch.from_numpy(wn).to(dev)
            at_ = torch.from_numpy(an).to(dev)
            host = build_bsr_int8_direct(wn, blk)
            gd = device_pack_gather(wt, blk)
            got = bsr_matmul_wt_xla(at_, gd)
            want = bsr_matmul_wt_xla(at_, pack_gather_bsr(host, dev))
            if not torch.equal(got, want):
                fail(f"device_pack_gather {name}: != the host pack")
            most = int(np.diff(host.row_ptr).max())
            try:
                device_pack_gather(wt, blk, lmax=most - 1)
            except ValueError as e:
                print(f"device_pack_gather {name}: product equal to the "
                      f"host pack's, lmax {gd.lmax}; lmax {most - 1} "
                      f"raises: {e}")
            else:
                fail(f"device_pack_gather {name}: lmax {most - 1} < {most} "
                     f"did not raise")
    art.cleanup()
    print(f"phase 28 (the artifact flow): {time.perf_counter() - t28:.1f} s")

    # ---- 29. LM serving: sampling, speculation, the batchers ----------
    from resnet_accel_tpu_torch.models.lm import adjust_logits, prng_key
    from resnet_accel_tpu_torch.runtime import (ContinuousBatcher,
                                                PagedKVBatcher)
    t29 = time.perf_counter()
    n_layers = LM_CFG["n_layers"]
    zlaunches = dict.fromkeys(_kernels.KERNELS, 0)

    def lm_served(fn, what, prefills):
        """``fn()`` on the host clock, counts reset just before: K5 must
        launch ``n_layers`` times a prefill (none on a batcher).  Returns
        (what fn returned, seconds)."""
        def run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0
        (out, dt), counts = served_launches(
            _kernels, run, ["flash_attention"] if prefills else [], what)
        if counts["flash_attention"] != n_layers * prefills:
            fail(f"{what}: flash_attention launched "
                 f"{counts['flash_attention']} times, not {n_layers} a "
                 f"prefill over {prefills}")
        for k, n in counts.items():
            zlaunches[k] += n
        return out, dt

    # 29.1 greedy speculative decoding against generate(flash=True), on the
    # seeded prompt (phase 13's tokens) and on a seeded 40-token motif
    # repeated to PROMPT tokens
    motif = np.random.default_rng(SEED + 3).integers(0, LM_CFG["vocab"], 40)
    rep_prompt = np.resize(motif, PROMPT).astype(np.int32)
    rep_toks, dt = lm_served(
        lambda: lmod.generate(rep_prompt, N_NEW, lm_scales, flash=True),
        "generate(flash=True), repetitive prompt", 1)
    print(f"generate(flash=True), repetitive prompt, {PROMPT} -> {N_NEW}: "
          f"{N_NEW / dt:.1f} tokens/s (host clock)  ({label})")
    spec_passes = {}
    for what, p, want in (("seeded", prompt, toks1),
                          ("repetitive", rep_prompt, rep_toks)):
        (got, passes), dt = lm_served(
            lambda: lmod.generate_speculative(
                p, N_NEW, lm_scales, draft=15, flash=True,
                return_stats=True),
            f"generate_speculative(flash=True), {what} prompt", 1)
        if not np.array_equal(got, want):
            fail(f"speculative tokens, {what} prompt, differ from "
                 f"generate(flash=True)'s at "
                 f"{np.flatnonzero(got != want)[:8].tolist()}")
        spec_passes[what] = passes
        print(f"generate_speculative(flash=True), {what} prompt, draft 15, "
              f"{PROMPT} -> {N_NEW}: tokens equal generate(flash=True)'s; "
              f"{passes} verify passes, {N_NEW / dt:.1f} tokens/s (host "
              f"clock)  ({label})")

    # 29.2 sampling: deterministic for a seed, another seed differs, top-k
    # 1 is greedy; sampled speculation deterministic for a seed
    def sample(seed, top_k=40, temperature=0.8, n_new=N_NEW):
        return lmod.sample(prompt, n_new, lm_scales, prng_key(seed),
                           temperature=temperature, top_k=top_k, flash=True)
    (s0, s0b, s1, top1), dt = lm_served(
        lambda: (sample(0), sample(0), sample(1), sample(0, top_k=1)),
        "sample(flash=True) x4", 4)
    if s0.shape != (N_NEW,) or s0.min() < 0 or s0.max() >= LM_CFG["vocab"]:
        fail(f"sampled tokens of shape {s0.shape} or out of the vocab")
    if not np.array_equal(s0, s0b):
        fail("sample(flash=True) is not deterministic for its seed")
    if not np.array_equal(top1, toks1):
        fail("sample(top_k=1) differs from greedy generate")
    with torch.inference_mode():
        first = lmod.prefill(prompt, sc, flash=True)[0]
        top2 = torch.topk(first, 2).values
        p_top = float(torch.softmax(adjust_logits(first, 0.8, 40), -1).max())
    print(f"sample(flash=True), T 0.8, top-k 40: deterministic for seed 0, "
          f"{int((s0 != s1).sum())} of {N_NEW} tokens differ for seed 1 "
          f"(the first draw: top logit {float(top2[0]):.2f}, next "
          f"{float(top2[1]):.2f}, top p {p_top:.6f}), top-k 1 equals greedy; "
          f"{4 * N_NEW / dt:.1f} tokens/s (host clock)  ({label})")
    # the tied readout puts the newest token's own logit far above the
    # rest on this random LM, so a seed shows only at a high temperature
    # (as tests/test_spec_sampling.py raises its own to 6 on its tiny LM)
    (h0, h1), _ = lm_served(
        lambda: (sample(0, temperature=100.0, n_new=64),
                 sample(1, temperature=100.0, n_new=64)),
        "sample(flash=True), T 100 x2", 2)
    if np.array_equal(h0, h1):
        fail("sample(flash=True) at T 100 equal for seeds 0 and 1")
    print(f"sample(flash=True), T 100, top-k 40: {int((h0 != h1).sum())} of "
          f"64 tokens differ between seeds 0 and 1")
    ((a, pa), (b, _)), dt = lm_served(
        lambda: [lmod.generate_speculative(
            rep_prompt, N_NEW, lm_scales, draft=15, flash=True,
            return_stats=True, temperature=0.8, top_k=40,
            rng_key=prng_key(0)) for _ in range(2)],
        "sampled generate_speculative(flash=True) x2", 2)
    if not np.array_equal(a, b):
        fail("sampled speculative decoding not deterministic for its seed")
    print(f"sampled generate_speculative, repetitive prompt, T 0.8, top-k "
          f"40: deterministic for seed 0, {pa} verify passes, "
          f"{2 * N_NEW / dt:.1f} tokens/s (host clock)  ({label})")

    # 29.3 the batchers' reference: generate(parallel_prefill=False), the
    # decode steps a batcher runs, batched (each row its own run, phase 13)
    NB = 64                               # new tokens a batcher request
    shared = np.concatenate([prompts[0][:PROMPT - 32], prompts[1][:32]])
    ref_prompts = np.concatenate([prompts, shared[None]])
    ref, dt = lm_served(
        lambda: lmod.generate(ref_prompts, NB, lm_scales,
                              parallel_prefill=False, batched=True),
        "generate(parallel_prefill=False), batched", 0)
    print(f"generate(parallel_prefill=False), batch {len(ref_prompts)}, "
          f"{PROMPT} -> {NB}: {ref.size / dt:.1f} tokens/s (host clock)  "
          f"({label})")
    reqs = [(p, NB) for p in prompts]

    # The first request's chain (its prompt, then its greedy tokens but
    # the last) one decode step a token on a cache of its own: its logits
    # at every position, which a verify row and a batcher's slot must give
    chain = np.concatenate([prompts[0], ref[0][:NB - 1]])
    n_chain = len(chain)
    chain_t = torch.as_tensor(chain, device=dev)

    def logits_held(what, got, want):
        """``got`` rows [n, V] against ``want``'s: fails beyond 1e-6;
        prints the largest |difference| and the rows not bit for bit."""
        err = max_abs_err(got, want)
        apart = int((got != want).any(dim=-1).sum())
        print(f"{what}: {got.shape[0]} rows, max |err| vs the lone decode "
              f"steps {err:.3g}, {apart} rows not bit for bit")
        if got.shape != want.shape or not err <= 1e-6:
            fail(f"{what}: logits off the lone decode steps by {err}")

    t0 = time.perf_counter()
    with torch.inference_mode():
        caches = lmod.init_caches()
        lone = []
        for tok in chain_t:
            lg, caches = lmod.decode_step(caches, tok, sc)
            lone.append(lg)
        lone = torch.stack(lone)                             # [n_chain, V]
        if not np.array_equal(lone[PROMPT - 1:].argmax(-1).cpu().numpy(),
                              ref[0][:NB]):
            fail("the lone decode steps' greedy tokens differ from "
                 "generate(parallel_prefill=False)'s")
        caches, rows = lmod.init_caches(), []
        for w in range(0, n_chain, 16):
            lv, caches = lmod.verify_step(caches, chain_t[w:w + 16], sc)
            rows.append(lv)
    print(f"lone decode of {n_chain} tokens and its verify passes: "
          f"{time.perf_counter() - t0:.1f} s")
    logits_held("verify_step, 16 rows a pass", torch.cat(rows), lone)

    def serve(engine, reqs):
        rids = [engine.submit(p, n) for p, n in reqs]
        res = engine.run()
        return [res[r] for r in rids]

    def recorded(eng, name):
        """Wrap the engine's device program ``name`` to keep each call's
        arguments and logits (references only: no host sync)."""
        calls, fn = [], getattr(eng, name)

        def wrapped(*args):
            out = fn(*args)
            calls.append((args, out[0] if isinstance(out, tuple) else out))
            return out
        setattr(eng, name, wrapped)
        return calls

    def slot0_rows(calls):
        """Slot 0's logits in each recorded call against the lone decode
        steps: a micro-step (toks [B], lens [B]) gives one row, a window
        (fed [B, S], positions [B, S], lens) the rows up to its first token
        off the chain.  Stops where slot 0 leaves the chain."""
        got, want, pos = [], [], -1
        for args, lg in calls:
            if lg.dim() == 2:                # a micro-step
                toks, p0 = args[0][:1], int(args[1][0])
                lg = lg[:1]
            else:
                toks, p0 = args[0][0], int(args[1][0, 0])
                lg = lg[0]
            if p0 < pos or p0 >= n_chain:
                break
            n = min(len(toks), n_chain - p0)
            same = (toks[:n] == chain_t[p0:p0 + n]).cpu().numpy()
            n = int(np.argmin(same)) if not same.all() else n
            got.append(lg[:n])
            want.append(lone[p0:p0 + n])
            pos = p0
        return torch.cat(got), torch.cat(want)

    def batcher(what, make, reqs, want, program=None):
        eng = make()
        calls = recorded(eng, program) if program else None
        got, dt = lm_served(lambda: serve(eng, reqs), what, 0)
        n_tok = sum(len(g) for g in got)
        agree = sum(int(np.sum(np.asarray(g) == w))
                    for g, w in zip(got, want))
        print(f"{what}: {len(reqs)} requests, {PROMPT} -> {NB}: {n_tok} "
              f"tokens, {n_tok / dt:.1f} tokens/s (host clock), "
              f"{eng.steps} engine steps / {eng.micro_steps} micro-steps; "
              f"{agree} of {n_tok} tokens equal generate's  ({label})")
        if calls is not None:
            with torch.inference_mode():
                g, w = slot0_rows(calls)
            if g.shape[0] < PROMPT:
                fail(f"{what}: only {g.shape[0]} of slot 0's rows follow "
                     "the first request's chain")
            logits_held(f"{what}, slot 0", g, w)
        return eng, got, agree == n_tok and n_tok == sum(map(len, want))

    pool = 1 + LM_BATCH * -(-(PROMPT + NB + 7) // 16)
    cases = [
        ("ContinuousBatcher, 8 slots, chunk 8", lambda: ContinuousBatcher(
            lm, lm_scales, slots=LM_BATCH, chunk=8, device=dev), reqs,
         ref[:LM_BATCH], "_decode"),
        (f"PagedKVBatcher, page 16, {pool} pages (< "
         f"{LM_BATCH * LM_CFG['max_len'] // 16} for slots x max_len), "
         f"chunk 8", lambda: PagedKVBatcher(
             lm, lm_scales, slots=LM_BATCH, page=16, pool_pages=pool,
             device=dev), reqs, ref[:LM_BATCH], "_micro_step"),
        ("PagedKVBatcher, spec_draft 7", lambda: PagedKVBatcher(
            lm, lm_scales, slots=LM_BATCH, page=16, pool_pages=pool,
            spec_draft=7, device=dev), reqs, ref[:LM_BATCH], "_forward")]
    for what, make, rq, want, program in cases:
        if not batcher(what, make, rq, want, program)[2]:
            fail(f"{what}: greedy streams differ from "
                 f"generate(parallel_prefill=False)")
    # two requests sharing PROMPT - 32 tokens, one after the other: the
    # second reuses the first's cached prompt pages
    eng, _, ok = batcher(
        "PagedKVBatcher, ondemand, prefix cache, 2 slots",
        lambda: PagedKVBatcher(lm, lm_scales, slots=2, page=16,
                               pool_pages=2 * 48 + 1, reserve="ondemand",
                               prefix_cache=True, device=dev),
        [(prompts[0], NB)], ref[:1])
    got, dt = lm_served(lambda: serve(eng, [(shared, NB)]),
                        "prefix-cached request", 0)
    if not ok or got[0] != ref[LM_BATCH].tolist():
        fail("ondemand prefix-cached streams differ from generate's")
    if eng.cache_tokens_skipped != PROMPT - 32:
        fail(f"prefix cache skipped {eng.cache_tokens_skipped} prompt "
             f"tokens, not {PROMPT - 32}")
    print(f"prefix-cached request: {eng.cache_hits} pages shared, "
          f"{eng.cache_tokens_skipped} prefill steps skipped, "
          f"{NB / dt:.1f} tokens/s (host clock); streams equal generate's")
    # int8 KV pages: lossy by design, its agreement printed, not required
    batcher("PagedKVBatcher, int8 KV, spec_draft 7", lambda: PagedKVBatcher(
        lm, lm_scales, slots=LM_BATCH, page=16, pool_pages=pool,
        kv_dtype="int8", spec_draft=7, device=dev), reqs, ref[:LM_BATCH])
    # teacher-forced scoring through the paged micro-steps
    seqs = [prompt[:200], prompts[2][:120]]
    eng = PagedKVBatcher(lm, lm_scales, slots=2, page=16, pool_pages=32,
                         device=dev)
    lps, dt = lm_served(lambda: eng.score(seqs), "score()", 0)
    with torch.inference_mode():
        for seq, lp in zip(seqs, lps):
            want = torch.log_softmax(lmod.forward(seq, lm_scales), -1)[
                torch.arange(len(seq) - 1), torch.as_tensor(
                    seq[1:], device=dev).long()].cpu().numpy()
            err = float(np.abs(lp - want).max())
            if lp.shape != want.shape or not err <= 1e-4:
                fail(f"score() off the teacher-forced forward by {err}")
            print(f"score(), {len(seq)} tokens: max |err| vs the "
                  f"teacher-forced forward {err:.3g} (within 1e-4)")
    print(f"score(): {sum(len(s) - 1 for s in seqs) / dt:.1f} tokens/s "
          f"(host clock)  ({label})")

    # 29.4 the CLI: generate --flash --speculative and serve
    lm_args = ["--layers", str(n_layers), "--d-model", str(LM_CFG["d_model"]),
               "--heads", str(LM_CFG["n_heads"]),
               "--vocab", str(LM_CFG["vocab"]),
               "--max-len", str(LM_CFG["max_len"]),
               "--sparsity", str(LM_CFG["sparsity"]), "--seed", str(SEED),
               "--device", dev.type]
    serve_prompts = [prompts[3][:64], prompts[4][:64]]
    serve_want = [lmod.generate(p, 32, lm_scales,
                                parallel_prefill=False).tolist()
                  for p in serve_prompts]
    for args, expect in (
            (["generate", "--flash", "--speculative", "--prompt",
              ",".join(map(str, prompt.tolist())), "--n-new", str(N_NEW)],
             [f"generated: {toks1.tolist()}",
              f"speculative: {spec_passes['seeded']} verify passes"]),
            (["serve", "--prompts", ";".join(",".join(map(str, p.tolist()))
                                            for p in serve_prompts),
              "--n-new", "32", "--page", "16", "--pool-pages", "16"],
             [f"-> {w}" for w in serve_want])):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "resnet_accel_tpu_torch", *args, *lm_args],
            cwd=repo, capture_output=True, text=True, timeout=300)
        print("\n".join(ln[:160] for ln in proc.stdout.splitlines()))
        print(f"{args[0]}: {time.perf_counter() - t0:.1f} s  ({label})")
        if proc.returncode != 0 or not all(e in proc.stdout for e in expect):
            print(proc.stderr, file=sys.stderr)
            fail(f"CLI {args[0]} exited {proc.returncode} or its tokens "
                 f"differ from the module's")
    print(f"phase 29 (LM serving): {time.perf_counter() - t29:.1f} s")

    # ---- 30. training on the card ---------------------------------------
    tlaunches = train_phase(repo, dev, label, _kernels)

    # ---- 31. parallelism: ranks sharing the card ------------------------
    plaunches = parallel_phase(
        dev, label, _kernels, model, sparse, batches[0], results[0].logits,
        sresults[0].logits, lm, lm_scales, lm_args, prompts, ref[:LM_BATCH])

    total = {name: launches[name] + launches50[name] + slaunches[name]
             + mlaunches[name] + llaunches[name] + claunches[name]
             + qlaunches[name] + rlaunches[name] + m14launches[name]
             + s14launches[name] + s128launches[name] + nlaunches[name]
             + alaunches[name] + zlaunches[name] + tlaunches[name]
             + plaunches[name]
             for name in _kernels.KERNELS}
    total["bsr_matmul"] += art_k4
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    kernels = []
    for name, k in _kernels.KERNELS.items():
        st = stats[name]
        kernels.append({
            "name": name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": total[name],
            "max_abs_err": st["err"], "ms": st["ms"],
            "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
            "bound_by": ("bytes" if st["bytes_ms"] >= st["ops_ms"]
                         else "operations"),
            "library_ms": st["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
