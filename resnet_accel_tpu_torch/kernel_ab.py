"""K3's and K4's times at the served shapes, for an A/B of two checkouts of
this package in one call on the card.

    python resnet_accel_tpu_torch/kernel_ab.py --repo P --repo C --repo C \\
        --repo P [--iters 20]

Each ``--repo`` is the root of a checkout (the directory that holds
``resnet_accel_tpu_torch/``).  Each runs in a process of its own, in the
order given (parent, change, change, parent compares two commits within
one call), builds that checkout's kernels and prints one JSON line a case:
``{"repo", "case", "ms", "plan"}`` with the median device time over
``--iters`` runs (CUDA events behind a spin of the card, as
``chip_smoke.py`` times), then a line with each case's ``torch._int_mm``
time (cuBLAS's dense int8 GEMM, plus the bias for K3) where cuBLAS takes
the shape.  The data are seeded: int8 activations and weights, block
masks drawn at the stated sparsity.

The cases: K3 at ResNet-18's and ResNet-50's fc (M 128, K 512 and 2048, N
1000, int32) and the MNIST CNN's dense fc1 (K 9216, N 128, requant and
ReLU) and fc2 (K 128, N 10); K4 at 128 x 128 blocks at the MNIST fc1
(0.9), the GEMM sweep's M 512, N = K = 2048 and 4096 (0.7, 0.9) and the
pruned ResNet-18's 18 sparse convs at batch 128 (0.7; im2col shapes,
summed); K4 at 14 x 14 (the ``mma_sync`` path) at the MNIST fc1 (its 128 x 128
blocks at 0.9 regrouped), the 2048 GEMM (0.7) and the 18 convs at batch 8
(0.7, summed).

    python resnet_accel_tpu_torch/kernel_ab.py --repo C --splits 1,2,4,8

times K3 and K4 instead at each cluster split given, forced in place of
the wrappers' choice (and at their choice), with the host time of one
call issued while the card spins, the card's event floor (a one-element
add), the fixed cost of a launch (K4 over weights that store no block)
and the sparse ResNet-18's b0.c1 and b2.c1 at batch 128 with int32 and
with served int8 output.  Needs a card; exits non-zero without one.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

#: The pruned ResNet-18's 18 sparse convs at 224 x 224 after im2col, per
#: image: (output pixels, K = C * k * k, N = output channels).
RESNET18_SPARSE_CONVS = (
    [(56 * 56, 576, 64)] * 4
    + [(28 * 28, 576, 128)] + [(28 * 28, 1152, 128)] * 3
    + [(14 * 14, 1152, 256)] + [(14 * 14, 2304, 256)] * 3
    + [(14 * 14, 128, 256)]
    + [(7 * 7, 2304, 512)] + [(7 * 7, 4608, 512)] * 3
    + [(7 * 7, 256, 512)])

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


def _run(repo: str, iters: int) -> None:
    """The cases against the package under ``repo``, in this process."""
    sys.path.insert(0, os.path.abspath(repo))
    import numpy as np
    import torch

    from resnet_accel_tpu_torch import _kernels, ops
    from resnet_accel_tpu_torch.sparse import build_bsr_int8_direct

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

    # ---- K3 ----
    for case, M, K, N, requant in (("fc512", 128, 512, 1000, False),
                                   ("fc2048", 128, 2048, 1000, False),
                                   ("mnist_fc1", 128, 9216, 128, True),
                                   ("mnist_fc2", 128, 128, 10, False)):
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
    def masked(N, K, block, sparsity, mask_block=None):
        """Random int8 W [N, K] with mask_block x mask_block tiles (block by
        default) zeroed with probability ``sparsity``, as BSR at block."""
        mb = mask_block or block
        W = rng.integers(-128, 128, (N, K)).astype(np.int8)
        keep = rng.random((-(-N // mb), -(-K // mb))) >= sparsity
        W *= np.repeat(np.repeat(keep, mb, 0), mb, 1)[:N, :K]
        return W, ops.pack_bsr(build_bsr_int8_direct(W, block), dev)

    def k4(case, A, pk, dense=None):
        emit(case, _time_ms(torch, lambda: ops.bsr_matmul_wt(A, pk), iters),
             plan_of("bsr_plan", A, pk))
        if dense is not None and A.shape[0] > 16:
            wt = torch.from_numpy(dense).to(dev).t()
            library[case] = _time_ms(torch, lambda: torch._int_mm(A, wt),
                                     iters)

    A = i8((128, 9216))
    for block in (128, 14):
        W, pk = masked(128, 9216, block, 0.9, mask_block=128)
        k4(f"K4 mnist_fc1 {block}", A, pk, W)
    for n, s in ((2048, 0.7), (2048, 0.9), (4096, 0.7), (4096, 0.9)):
        A = i8((512, n))
        W, pk = masked(n, n, 128, s)
        k4(f"K4 gemm{n} {s} 128", A, pk, W)
    A = i8((512, 2048))
    W, pk = masked(2048, 2048, 14, 0.7)
    k4("K4 gemm2048 0.7 14", A, pk, W)
    for block, batch in ((128, 128), (14, 8)):
        total = lib_total = 0.0
        plans = set()
        for pix, K, N in RESNET18_SPARSE_CONVS:
            A = i8((batch * pix, K))
            W, pk = masked(N, K, block, 0.7)
            total += _time_ms(torch, lambda: ops.bsr_matmul_wt(A, pk),
                              iters)
            plans.add(plan_of("bsr_plan", A, pk))
            wt = torch.from_numpy(W).to(dev).t()
            lib_total += _time_ms(torch, lambda: torch._int_mm(A, wt), iters)
            del A
        emit(f"K4 resnet18 18 convs {block} batch {batch}", total,
             " ".join(sorted(str(p) for p in plans)))
        library[f"K4 resnet18 18 convs {block} batch {batch}"] = lib_total
    print(json.dumps({"repo": repo, "library_ms": library}), flush=True)


def _split_sweep(repo: str, iters: int, splits) -> None:
    """K3 and K4 at each cluster split of ``splits``, forced in place of
    the wrappers' choice, with the fixed cost of a launch (K4 over a weight
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
    ap.add_argument("--splits", default="",
                    help="e.g. 1,2,4,8: time K3 and K4 at each cluster "
                         "split instead of the A/B cases")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        if args.splits:
            _split_sweep(args.repo[0], args.iters,
                         [int(s) for s in args.splits.split(",")])
        else:
            _run(args.repo[0], args.iters)
        return 0
    for repo in args.repo:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", "--repo", repo, "--iters",
                               str(args.iters), "--splits", args.splits])
        if proc.returncode != 0:
            return proc.returncode
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
