"""ctypes binding of the repo's native host library (``native/``).

Counterpart of ``resnet_accel_tpu/native/__init__.py``: the same entry
points -- the bit-exact golden models, the BSR packer and serializer, and
the threaded int8 ``BatchLoader`` that feeds ``InferenceEngine.stream`` --
bound to the same C ABI (``native/include/rat_native.h``).

The library is built here, at first use, from the C++ sources under
``native/src`` exactly as they are, with ``g++`` and the flags of
``native/Makefile`` (``-O2 -std=c++17 -fPIC -pthread``, linked ``-shared
-pthread``), into ``_build/``: one ``g++`` a source, all at once, then
one link.  The file is named by a hash of the sources, the header and the
flags, and is moved into place with ``os.replace``, so processes that
build at once each land a whole library and a change to a source rebuilds
it.  Nothing is built when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional, Tuple, Union

import numpy as np
import torch

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NATIVE_DIR = os.path.join(os.path.dirname(PKG_DIR), "native")
SOURCES = [os.path.join(NATIVE_DIR, "src", f) for f in
           ("golden.cpp", "bsr_packer.cpp", "arena.cpp", "loader.cpp")]
HEADER = os.path.join(NATIVE_DIR, "include", "rat_native.h")
CXXFLAGS = ["-O2", "-std=c++17", "-fPIC", "-pthread",
            "-I" + os.path.join(NATIVE_DIR, "include")]
LDFLAGS = ["-shared", "-pthread"]

_c = ctypes
_i8p, _i32p, _f32p, _u8p = (_c.POINTER(_c.c_int8), _c.POINTER(_c.c_int32),
                            _c.POINTER(_c.c_float), _c.POINTER(_c.c_uint8))
_i64 = _c.c_int64
#: Every entry point the JAX package's binding declares: (restype, argtypes).
SIGNATURES = {
    "rat_matmul_int8": (None, [_i8p, _i8p, _i32p, _i64, _i64, _i64]),
    "rat_bsr_matmul_int8": (
        None, [_i8p, _i8p, _i32p, _i32p, _i32p] + [_i64] * 6),
    "rat_bsr_matmul_int8_wt": (
        None, [_i8p, _i8p, _i32p, _i32p, _i32p] + [_i64] * 6),
    "rat_relu_int8": (None, [_i8p, _i64]),
    "rat_requantize_int32_to_int8": (
        None, [_i32p, _i8p, _i64, _c.c_float, _c.c_float]),
    "rat_requantize_q16": (None, [_i32p, _i8p, _i64, _c.c_uint32, _c.c_int]),
    "rat_requantize_per_channel": (
        None, [_i32p, _i8p, _i64, _f32p, _i64, _i64]),
    "rat_add_residual_int8": (
        None, [_i8p, _i8p, _i8p, _i64] + [_c.c_float] * 3),
    "rat_maxpool2d_int8": (None, [_i8p, _i8p] + [_i64] * 6),
    "rat_avgpool_global_int8": (None, [_i8p, _i8p, _i64, _i64, _i64]),
    "rat_im2col_int8": (None, [_i8p, _i8p] + [_i64] * 6),
    "rat_conv2d_int8": (None, [_i8p, _i8p, _i32p, _i32p] + [_i64] * 7),
    "rat_bsr_pack_count": (_i64, [_i8p] + [_i64] * 4),
    "rat_bsr_pack_fill": (_i64, [_i8p] + [_i64] * 4 + [_i8p, _i32p, _i32p]),
    "rat_bsr_unpack": (None, [_i8p, _i32p, _i32p, _i8p] + [_i64] * 4),
    "rat_bsr_serialize_hw_size": (_i64, [_i64] * 4),
    "rat_bsr_serialize_hw": (_i64, [_i8p, _i32p, _i32p, _u8p] + [_i64] * 5),
    "rat_loader_create": (
        _c.c_void_p, [_u8p, _i64, _i64, _i32p, _i64, _i64, _f32p, _f32p,
                      _c.c_float, _c.c_int, _c.c_uint64, _c.c_int,
                      _c.c_int]),
    "rat_loader_next": (_i64, [_c.c_void_p, _i8p, _i32p]),
    "rat_loader_batches_per_epoch": (_i64, [_c.c_void_p]),
    "rat_loader_destroy": (None, [_c.c_void_p]),
    "rat_self_test": (_c.c_int, []),
    "rat_version": (_c.c_char_p, []),
}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def _digest() -> str:
    h = hashlib.sha256(" ".join(CXXFLAGS + LDFLAGS).encode())
    for path in SOURCES + [HEADER]:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile ``native/src/*.cpp`` into ``_build/`` unless a build of the
    same sources and flags is there; returns the library's path."""
    path = os.path.join(BUILD_DIR, f"libresnet_accel_host-{_digest()}.so")
    if os.path.exists(path):
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native host library cannot "
                           "be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [os.path.join(work, os.path.basename(s) + ".o")
                for s in SOURCES]
        procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True))
                 for cmd in ([cxx, *CXXFLAGS, "-c", src, "-o", obj]
                             for src, obj in zip(SOURCES, objs))]
        errors = []
        for cmd, proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{' '.join(cmd)}\n{err}")
        tmp = os.path.join(work, "lib.so")
        if not errors:
            link = [cxx, *LDFLAGS, *objs, "-o", tmp]
            proc = subprocess.run(link, capture_output=True, text=True)
            if proc.returncode != 0:
                errors.append(f"{' '.join(link)}\n{proc.stderr}")
        if errors:
            raise RuntimeError("g++ failed:\n" + "\n".join(errors))
        os.replace(tmp, path)
    return path


def lib() -> ctypes.CDLL:
    """The loaded host library, built on first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, (res, args) in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.restype, fn.argtypes = res, args
            _lib = handle
        return _lib


def version() -> str:
    return lib().rat_version().decode()


def self_test() -> int:
    return lib().rat_self_test()


def _p(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def matmul_int8(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a, np.int8)
    b = np.ascontiguousarray(b, np.int8)
    m, k = a.shape
    if b.shape[0] != k:
        raise ValueError(f"shape mismatch: {a.shape} @ {b.shape}")
    c = np.zeros((m, b.shape[1]), np.int32)
    lib().rat_matmul_int8(_p(a, _c.c_int8), _p(b, _c.c_int8),
                          _p(c, _c.c_int32), m, k, b.shape[1])
    return c


def _bsr_arrays(blocks, row_ptr, col_idx, bh, bw):
    """The BSR arrays as the C side reads them; raise where the row
    pointers would take it past the stored blocks."""
    blocks = np.ascontiguousarray(blocks, np.int8)
    row_ptr = np.ascontiguousarray(row_ptr, np.int32)
    col_idx = np.ascontiguousarray(col_idx, np.int32)
    if (blocks.ndim != 3 or blocks.shape[1:] != (bh, bw) or row_ptr.size < 1
            or row_ptr[0] != 0 or np.any(np.diff(row_ptr) < 0)
            or row_ptr[-1] > min(len(blocks), len(col_idx))):
        raise ValueError(f"inconsistent BSR arrays: blocks {blocks.shape}, "
                         f"row_ptr ending at {row_ptr[-1:]}, "
                         f"{len(col_idx)} column indices, {bh}x{bw} blocks")
    return blocks, row_ptr, col_idx


def bsr_matmul_int8_wt(a, blocks, row_ptr, col_idx, bh, bw, n_out):
    """C[M, n_out] = A[M, K] @ W^T, W [n_out, K] in BSR."""
    a = np.ascontiguousarray(a, np.int8)
    blocks, row_ptr, col_idx = _bsr_arrays(blocks, row_ptr, col_idx, bh, bw)
    m, k = a.shape
    c = np.zeros((m, n_out), np.int32)
    lib().rat_bsr_matmul_int8_wt(
        _p(a, _c.c_int8), _p(blocks, _c.c_int8), _p(row_ptr, _c.c_int32),
        _p(col_idx, _c.c_int32), _p(c, _c.c_int32), m, k, n_out, bh, bw,
        len(row_ptr) - 1)
    return c


def requantize_int32_to_int8(x, in_scale, out_scale):
    x = np.ascontiguousarray(x, np.int32)
    out = np.empty(x.shape, np.int8)
    lib().rat_requantize_int32_to_int8(
        _p(x, _c.c_int32), _p(out, _c.c_int8), x.size, in_scale, out_scale)
    return out


def requantize_q16(x, scale_q16, relu=False):
    x = np.ascontiguousarray(x, np.int32)
    out = np.empty(x.shape, np.int8)
    lib().rat_requantize_q16(_p(x, _c.c_int32), _p(out, _c.c_int8), x.size,
                             int(scale_q16) & 0xFFFFFFFF, int(bool(relu)))
    return out


def add_residual_int8(m, r, ms, rs, os_):
    m = np.ascontiguousarray(m, np.int8)
    r = np.ascontiguousarray(r, np.int8)
    if m.shape != r.shape:
        raise ValueError(f"shape mismatch: {m.shape} and {r.shape}")
    out = np.empty(m.shape, np.int8)
    lib().rat_add_residual_int8(_p(m, _c.c_int8), _p(r, _c.c_int8),
                                _p(out, _c.c_int8), m.size, ms, rs, os_)
    return out


def maxpool2d_int8(x, pool, stride, padding=0):
    """CHW int8 max pool."""
    x = np.ascontiguousarray(x, np.int8)
    c, h, w = x.shape
    ho = (h + 2 * padding - pool) // stride + 1
    wo = (w + 2 * padding - pool) // stride + 1
    out = np.empty((c, ho, wo), np.int8)
    lib().rat_maxpool2d_int8(_p(x, _c.c_int8), _p(out, _c.c_int8), c, h, w,
                             pool, stride, padding)
    return out


def avgpool_global_int8(x):
    """CHW int8 -> [C] int8 global average pool."""
    x = np.ascontiguousarray(x, np.int8)
    c, h, w = x.shape
    out = np.empty(c, np.int8)
    lib().rat_avgpool_global_int8(_p(x, _c.c_int8), _p(out, _c.c_int8),
                                  c, h, w)
    return out


def conv2d_int8(x, weight, bias, stride=1, padding=0):
    """CHW int8 input, OIHW int8 weight, int32 bias or None -> int32."""
    x = np.ascontiguousarray(x, np.int8)
    weight = np.ascontiguousarray(weight, np.int8)
    c_out, c_in, k, _ = weight.shape
    c, h, w = x.shape
    if c != c_in:
        raise ValueError(f"input has {c} channels, weight {c_in}")
    ho = (h + 2 * padding - k) // stride + 1
    wo = (w + 2 * padding - k) // stride + 1
    out = np.zeros((c_out, ho, wo), np.int32)
    b = None if bias is None else np.ascontiguousarray(bias, np.int32)
    lib().rat_conv2d_int8(
        _p(x, _c.c_int8), _p(weight, _c.c_int8),
        None if b is None else _p(b, _c.c_int32), _p(out, _c.c_int32),
        c_in, h, w, c_out, k, stride, padding)
    return out


def bsr_pack(dense: np.ndarray, bh: int, bw: int
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """dense int8 [H, W] -> (blocks, row_ptr, col_idx)."""
    handle = lib()
    dense = np.ascontiguousarray(dense, np.int8)
    h, w = dense.shape
    nnz = handle.rat_bsr_pack_count(_p(dense, _c.c_int8), h, w, bh, bw)
    blocks = np.zeros((nnz, bh, bw), np.int8)
    row_ptr = np.zeros(-(-h // bh) + 1, np.int32)
    col_idx = np.zeros(max(nnz, 1), np.int32)
    handle.rat_bsr_pack_fill(_p(dense, _c.c_int8), h, w, bh, bw,
                             _p(blocks, _c.c_int8), _p(row_ptr, _c.c_int32),
                             _p(col_idx, _c.c_int32))
    return blocks, row_ptr, col_idx[:nnz]


def bsr_serialize_hw(blocks, row_ptr, col_idx, nbc) -> bytes:
    """The hardware stream: 12-byte header, u16 row_ptr and col_idx, the
    int8 blocks."""
    handle = lib()
    blocks = np.asarray(blocks)
    blocks, row_ptr, col_idx = _bsr_arrays(blocks, row_ptr, col_idx,
                                           *blocks.shape[1:])
    nnz, bh, bw = blocks.shape
    nbr = len(row_ptr) - 1
    buf = np.zeros(handle.rat_bsr_serialize_hw_size(nnz, nbr, bh, bw),
                   np.uint8)
    written = handle.rat_bsr_serialize_hw(
        _p(blocks, _c.c_int8), _p(row_ptr, _c.c_int32),
        _p(col_idx, _c.c_int32), _p(buf, _c.c_uint8), nnz, nbr, nbc, bh, bw)
    if written < 0:
        raise ValueError("hw stream: u16 overflow")
    return buf.tobytes()


class BatchLoader:
    """The threaded native batch loader: C++ workers gather, normalize and
    int8-quantize batches into a bounded ring ahead of the consumer,

        out = clip(rint(((u8 / 255) - mean[c]) / std[c] / quant_scale)),

    all in float32.  Batch j depends only on (seed, j) and is delivered in
    sequence order whatever ``n_threads``; a last partial batch is dropped.
    ``images_u8`` is [n, C, ...] (channel-major items), ``labels`` [n] or
    None; ``quant_scale`` is the model's ``s_input``.
    """

    def __init__(self, images_u8: np.ndarray, labels, batch: int,
                 mean, std, quant_scale: float, shuffle: bool = True,
                 seed: int = 0, n_threads: int = 2, depth: int = 2):
        handle = lib()
        imgs = np.ascontiguousarray(images_u8, np.uint8)
        if imgs.ndim < 2:
            raise ValueError("images must be [n, ...]")
        n = imgs.shape[0]
        self.item_shape = imgs.shape[1:]
        self.item_len = int(np.prod(self.item_shape))
        mean_f = np.ascontiguousarray(mean, np.float32).reshape(-1)
        std_f = np.ascontiguousarray(std, np.float32).reshape(-1)
        self.has_labels = labels is not None
        lab = (None if labels is None
               else np.ascontiguousarray(labels, np.int32))
        if lab is not None and lab.shape != (n,):
            raise ValueError(f"labels {lab.shape}, expected ({n},)")
        self._lib = handle
        # the C side copies images, labels, mean and std before returning
        self._h = handle.rat_loader_create(
            _p(imgs.reshape(n, self.item_len), _c.c_uint8), n, self.item_len,
            None if lab is None else _p(lab, _c.c_int32), batch,
            mean_f.size, _p(mean_f, _c.c_float), _p(std_f, _c.c_float),
            _c.c_float(quant_scale), int(shuffle), seed, n_threads, depth)
        if not self._h:
            raise ValueError("invalid loader configuration")
        self.batch = batch
        self.batches_per_epoch = int(
            handle.rat_loader_batches_per_epoch(self._h))

    def next(self, out: Union[None, np.ndarray, torch.Tensor] = None):
        """The next batch: (int8 [batch, *item_shape], int32 labels [batch]).
        With ``out`` (an int8 numpy array or CPU tensor, pinned or not, of
        ``batch * item_len`` contiguous elements) the loader writes the
        images straight into it and returns it."""
        if self._h is None:
            raise RuntimeError("loader is closed")
        shape = (self.batch,) + tuple(self.item_shape)
        if out is None:
            dst = np.empty(shape, np.int8)
            ptr = _p(dst, _c.c_int8)
        elif isinstance(out, torch.Tensor):
            if (out.dtype != torch.int8 or out.device.type != "cpu"
                    or not out.is_contiguous()
                    or out.numel() != self.batch * self.item_len):
                raise ValueError(
                    f"out: {out.dtype} {tuple(out.shape)} on {out.device}; "
                    f"expected a contiguous int8 CPU tensor of "
                    f"{self.batch * self.item_len} elements")
            dst = out
            ptr = ctypes.cast(out.data_ptr(), _i8p)
        else:
            if (out.dtype != np.int8 or not out.flags.c_contiguous
                    or out.size != self.batch * self.item_len):
                raise ValueError(
                    f"out: {out.dtype} {out.shape}; expected a contiguous "
                    f"int8 array of {self.batch * self.item_len} elements")
            dst = out
            ptr = _p(out, _c.c_int8)
        lab = np.empty(self.batch, np.int32)
        if self._lib.rat_loader_next(self._h, ptr, _p(lab, _c.c_int32)) < 0:
            raise RuntimeError("loader next failed")
        return dst, lab

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.rat_loader_destroy(self._h)
        self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
