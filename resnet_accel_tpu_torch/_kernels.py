"""Build, load and launch the hand-written Hopper kernels.

The CUDA sources under ``csrc/`` expose a plain C interface.  At the first
CUDA use they are compiled with ``nvcc`` for ``sm_90a`` (one process per
source, in parallel), linked into ``_build/libkernels.so`` and loaded with
``ctypes``; nothing is built or
loaded when the package is imported, so the CPU path needs neither
``nvcc`` nor a card.  The build is keyed by a hash of the sources and the
flags and is redone when either changes.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`launch` raises on a non-zero code and adds
one to the kernel's launch count, and to the count of the variant it was
given (K2's, K3's, K4's, K7's and K8's paths, chosen by shape: K4's
``wgmma_tma``, ``wgmma_small`` for blocks of at most 16 x 16,
``mma_sync``; K7's and K8's ``wgmma_tma``, ``mma_sync``; K4's conv route
``bsr_conv``, one variant, ``wgmma_gather``).  The counts
let a run show that its main path really went through the kernels, and
which path.

K2, K3, K4, K7 and K8 share a Hopper main loop (``csrc/sm90_gemm_s8.cuh``)
whose tensor maps are encoded on the host by ``cuTensorMapEncodeTiled``
(and ``cuTensorMapEncodeIm2col`` for K2 and K8): the library fetches them
through ``cudaGetDriverEntryPoint`` at run time, so the link line needs
no ``-lcuda``.  :func:`cluster_split` and :func:`split_share` are the
schedule of its split-K clusters, as the kernel computes it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, List, Optional

import torch

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libkernels.so")

# No --use_fast_math, and -fmad=false so that no a*b+c in the epilogues is
# contracted into an FMA: the golden rounds every f32 operation on its own.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float


@dataclasses.dataclass
class Kernel:
    """One hand-written kernel: its C entry point and its launch count."""

    name: str
    symbol: str
    source: str            # path in the repo
    replaces: str          # the TPU kernel it replaces, file:line, or none
    argtypes: List
    launches: int = 0
    variants: Dict[str, int] = dataclasses.field(default_factory=dict)


KERNELS: Dict[str, Kernel] = {
    k.name: k for k in (
        Kernel("stem_fused", "stem_fused_launch",
               "resnet_accel_tpu_torch/csrc/stem_fused.cu",
               "resnet_accel_tpu/ops/stem_fused.py:115",
               [_P] * 5 + [_I] * 6 + [_F, _P]),
        Kernel("conv_int8", "conv_int8_launch",
               "resnet_accel_tpu_torch/csrc/conv_int8.cu",
               "resnet_accel_tpu/ops/conv_bm.py:419",
               [_P] * 6 + [_I] * 13 + [_F] * 3 + [_P]),
        Kernel("matmul_int8", "matmul_int8_launch",
               "resnet_accel_tpu_torch/csrc/matmul_int8.cu",
               "resnet_accel_tpu/ops/matmul_int8.py:74",
               [_P] * 5 + [_I] * 7 + [_P]),
        Kernel("bsr_matmul", "bsr_matmul_launch",
               "resnet_accel_tpu_torch/csrc/bsr_matmul.cu",
               "resnet_accel_tpu/ops/bsr_matmul.py:194",
               [_P] * 7 + [_I] * 13 + [_P]),
        Kernel("expand_add", "expand_add_launch",
               "resnet_accel_tpu_torch/csrc/expand_add.cu",
               "resnet_accel_tpu/ops/expand_fused.py:49",
               [_P] * 6 + [_I] * 5 + [_F] * 4 + [_P]),
        Kernel("flash_attention", "flash_attention_launch",
               "resnet_accel_tpu_torch/csrc/flash_attention.cu",
               "resnet_accel_tpu/ops/flash_attention.py:43",
               [_P] * 5 + [_I] * 5 + [_F, _P]),
        Kernel("sparse_conv", "sparse_conv_launch",
               "resnet_accel_tpu_torch/csrc/sparse_conv.cu",
               "resnet_accel_tpu/ops/sparse_conv.py:150",
               [_P] * 10 + [_I] * 17 + [_P]),
        Kernel("stem_int8", "stem_int8_launch",
               "resnet_accel_tpu_torch/csrc/stem_int8.cu",
               "resnet_accel_tpu/ops/fused_stem.py:82",
               [_P] * 5 + [_I] * 7 + [_P]),
        Kernel("stem_pack", "stem_pack_launch",
               "resnet_accel_tpu_torch/csrc/stem_pack.cu",
               "resnet_accel_tpu/ops/stem_pack.py:142",
               [_P] * 2 + [_I] * 4 + [_F, _P]),
        Kernel("bsr_conv", "bsr_conv_launch",
               "resnet_accel_tpu_torch/csrc/bsr_conv.cu",
               "none: K4's conv route, im2col, K4 and the join in one",
               [_P] * 10 + [_I] * 26 + [_F] * 3 + [_P]),
    )
}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
        k.variants.clear()


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def variant_counts() -> Dict[str, Dict[str, int]]:
    """Launches by variant, for the kernels that have more than one path."""
    return {name: dict(k.variants) for name, k in KERNELS.items()
            if k.variants}


# ---- the split-K schedule of csrc/sm90_gemm_s8.cuh ------------------------

@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """The path of one K3, K4 or K8 call: its variant, its N tile (columns
    a CTA; 0 on the ``mma_sync`` paths) and its cluster split along K."""

    variant: str
    bn: int
    split: int


#: CTAs of a cluster at most.  The kernel takes up to 8 (the portable
#: cluster size), but on the H100 a cluster of 4 or 8 costs 4-5 us more
#: than one of 2 even with nothing to sum, and a grid of such clusters
#: launches slower still (``kernel_ab.py --splits``; PERF.md §6).
MAX_SPLIT = 2
#: A split pays only where every rank of the longest walk keeps more than
#: this many units: on the H100 a cluster launch costs 1-2 us more than a
#: plain one, a unit (a 128-byte K stage) 0.2-0.5 us (``kernel_ab.py
#: --splits``; PERF.md §6).
MIN_RANK_WALK = 4
#: The H100's SMs: the schedule's default where no card is asked.
H100_SMS = 132


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The SMs of ``device`` (a CUDA device)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def cluster_split(ctas: int, walk: int, sms: int = H100_SMS) -> int:
    """CTAs of a cluster along K for a grid of ``ctas`` tiles whose longest
    walk is ``walk`` units (K tiles or stored blocks' stages): doubled from
    1 while the grid stays within one CTA an SM of ``sms`` and every rank
    of the longest walk keeps more than :data:`MIN_RANK_WALK` units, at
    most :data:`MAX_SPLIT`."""
    split = 1
    while (split < MAX_SPLIT and ctas * split * 2 <= sms
           and walk > MIN_RANK_WALK * split * 2):
        split *= 2
    return split


def split_share(n: int, split: int, rank: int) -> range:
    """The units of ``n`` that rank ``rank`` of ``split`` walks: the
    kernel's ``sm90::split_share``."""
    per = -(-n // split)
    lo = min(n, rank * per)
    return range(lo, min(n, lo + per))


def _sources() -> List[str]:
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built (set CUDA_HOME or put nvcc on PATH)")
    return found


def build(verbose: bool = False) -> str:
    """Compile ``csrc/*.cu`` into ``_build/libkernels.so`` unless a build
    of the same sources and flags is already there; returns its path."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    digest = h.hexdigest()
    stamp = LIB_PATH + ".sha256"
    if os.path.exists(LIB_PATH) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == digest:
                return LIB_PATH
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    cu = [p for p in _sources() if p.endswith(".cu")]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        # One nvcc per source, all at once; then one link.
        objs = [os.path.join(work, os.path.basename(p) + ".o") for p in cu]
        procs = []
        for src, obj in zip(cu, objs):
            cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas=-v"] if verbose else []),
                   "-c", "-o", obj, src]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        tmp = os.path.join(work, "libkernels.so")
        link = [nvcc, "-shared", "-o", tmp, *objs]
        errors = []
        t0 = time.perf_counter()
        for (cmd, proc), src in zip(procs, cu):
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{' '.join(cmd)}\n{err}")
            elif verbose:
                print(err, end="")
                print(f"nvcc {os.path.basename(src)}: done by "
                      f"{time.perf_counter() - t0:.1f} s")
        if not errors:
            proc = subprocess.run(link, capture_output=True, text=True)
            if proc.returncode != 0:
                errors.append(f"{' '.join(link)}\n{proc.stderr}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        os.replace(tmp, LIB_PATH)
    with open(stamp, "w") as f:
        f.write(digest + "\n")
    return LIB_PATH


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for k in KERNELS.values():
                fn = getattr(handle, k.symbol)
                fn.argtypes = k.argtypes
                fn.restype = ctypes.c_int
            handle.kernels_error_string.argtypes = [ctypes.c_int]
            handle.kernels_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def _call(symbol: str, device: torch.device, args) -> None:
    handle = lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = getattr(handle, symbol)(*args, stream)
    if err != 0:
        msg = handle.kernels_error_string(err).decode()
        raise RuntimeError(f"{symbol} launch failed: {msg} ({err})")


def launch(name: str, device: torch.device, *args,
           variant: Optional[str] = None) -> None:
    """Launch kernel ``name`` on ``device``'s current stream; raise if the
    launch was refused.  ``args`` are the C arguments before the stream;
    ``variant`` names the path taken, counted beside the launch."""
    k = KERNELS[name]
    _call(k.symbol, device, args)
    k.launches += 1
    if variant is not None:
        k.variants[variant] = k.variants.get(variant, 0) + 1


def launch_probe(symbol: str, argtypes: List, device: torch.device,
                 *args) -> None:
    """Launch the probe ``symbol`` of ``csrc/probes.cu`` as :func:`launch`
    does a kernel, but count nothing: a probe is on no path."""
    fn = getattr(lib(), symbol)
    fn.argtypes, fn.restype = argtypes + [_P], ctypes.c_int
    _call(symbol, device, args)


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape,
          device: torch.device,
          memory_format: torch.memory_format = torch.contiguous_format
          ) -> None:
    """Raise unless ``t`` is what a kernel takes: device, dtype, shape and
    a dense layout in ``memory_format``."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous(memory_format=memory_format):
        raise ValueError(f"{name}: not contiguous in {memory_format}")
