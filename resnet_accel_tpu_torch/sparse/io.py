"""BSR artifact I/O: the layouts the reference's data tree uses.

A numpy copy of ``resnet_accel_tpu/sparse/io.py``, kept here so the port
imports nothing of the JAX package; files either package writes are
byte-identical and each reads the other's (the tests hold them so).

1. **Layer directory** (export_bsr_14x14.py save_* family):
   ``weights.bsr`` (raw contiguous row-major INT8 blocks), ``row_ptr.npy``,
   ``col_idx.npy``, ``weights.meta.json``.
2. **Fixture directory** (sw/exporters/*): ``weights_int8.bsr`` +
   ``weights.meta.json`` (row_ptr/col_idx live in the JSON) + optional
   ``scales.npy`` / ``bias.npy`` / ``metadata.json``.
3. **Hardware stream** (bsr_packer.hpp:492-575): ``[12-byte header:
   nnz, num_block_rows, num_block_cols as u32 LE][row_ptr u16]
   [col_idx u16][blocks int8]``.
4. **DMA image** (sw/host/memory.py pack_for_dma): ``[row_ptr u32]
   [col_idx u16][blocks int8]`` with geometry carried out of band.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Optional, Tuple

import numpy as np

from resnet_accel_tpu_torch.sparse.bsr import BSRMatrix


# --------------------------------------------------------------------------
# 1/2. Directory layouts
# --------------------------------------------------------------------------

def save_layer_dir(bsr: BSRMatrix, out_dir: str, layer_name: str) -> None:
    """Write the export_bsr_14x14-style layer directory."""
    os.makedirs(out_dir, exist_ok=True)
    if bsr.data.dtype != np.int8:
        raise ValueError("layer dir format stores INT8 blocks")
    with open(os.path.join(out_dir, "weights.bsr"), "wb") as f:
        f.write(np.ascontiguousarray(bsr.data).tobytes())
    np.save(os.path.join(out_dir, "row_ptr.npy"),
            bsr.row_ptr.astype(np.int32))
    np.save(os.path.join(out_dir, "col_idx.npy"),
            bsr.col_idx.astype(np.int32))
    with open(os.path.join(out_dir, "weights.meta.json"), "w") as f:
        json.dump(bsr_metadata(bsr, layer_name), f, indent=2)


def bsr_metadata(bsr: BSRMatrix, layer_name: str) -> dict:
    """The weights.meta.json schema (export_bsr_14x14.py:274-317)."""
    tiles_per_row = [int(x) for x in bsr.tiles_per_row]
    return {
        "layer_name": layer_name,
        "shape": list(bsr.shape),
        "padded_shape": list(bsr.padded_shape),
        "blocksize": [bsr.block_h, bsr.block_w],
        "num_blocks": bsr.nnz_blocks,
        "num_block_rows": bsr.num_block_rows,
        "num_block_cols": bsr.num_block_cols,
        "density": float(bsr.density),
        "sparsity_pct": float(bsr.sparsity_pct),
        "row_ptr": [int(x) for x in bsr.row_ptr],
        "col_idx": [int(x) for x in bsr.col_idx],
        "tiles_per_row": tiles_per_row,
        "max_tiles_per_row": max(tiles_per_row) if tiles_per_row else 0,
        "bytes_per_block": bsr.block_h * bsr.block_w,
        "total_weight_bytes": bsr.nnz_blocks * bsr.block_h * bsr.block_w,
    }


def load_layer_dir(layer_dir: str) -> BSRMatrix:
    """Load either directory layout (layer export or fixture).

    Accepts ``weights.bsr`` + ``row_ptr.npy``/``col_idx.npy`` (layer
    layout) or ``weights_int8.bsr`` with row_ptr/col_idx from
    ``weights.meta.json`` (fixture layout).
    """
    meta_path = os.path.join(layer_dir, "weights.meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    block_h, block_w = meta["blocksize"]
    num_blocks = meta["num_blocks"]

    bsr_path = os.path.join(layer_dir, "weights.bsr")
    if not os.path.isfile(bsr_path):
        bsr_path = os.path.join(layer_dir, "weights_int8.bsr")
    with open(bsr_path, "rb") as f:
        raw = np.frombuffer(f.read(), dtype=np.int8)
    expected = num_blocks * block_h * block_w
    if raw.size != expected:
        raise ValueError(
            f"{bsr_path}: {raw.size} bytes, expected {expected} "
            f"({num_blocks} blocks of {block_h}x{block_w})")
    data = raw.reshape(num_blocks, block_h, block_w).copy()

    rp_path = os.path.join(layer_dir, "row_ptr.npy")
    if os.path.isfile(rp_path):
        row_ptr = np.load(rp_path).astype(np.int32)
        col_idx = np.load(os.path.join(layer_dir, "col_idx.npy")).astype(np.int32)
    else:
        row_ptr = np.asarray(meta["row_ptr"], dtype=np.int32)
        col_idx = np.asarray(meta["col_idx"], dtype=np.int32)

    return BSRMatrix(
        data=data,
        row_ptr=row_ptr,
        col_idx=col_idx,
        shape=tuple(meta["shape"]),
        block_h=block_h,
        block_w=block_w,
    )


def load_layer_scales_bias(
    layer_dir: str,
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """Load per-channel scales and bias if present (fixture layout)."""
    scales = bias = None
    sp = os.path.join(layer_dir, "scales.npy")
    bp = os.path.join(layer_dir, "bias.npy")
    if os.path.isfile(sp):
        scales = np.load(sp).astype(np.float32)
    if os.path.isfile(bp):
        bias = np.load(bp)
    return scales, bias


# --------------------------------------------------------------------------
# 3. Hardware stream format (bsr_packer.hpp serialization)
# --------------------------------------------------------------------------

def serialize_hw_stream(bsr: BSRMatrix) -> bytes:
    """[12B header: nnz,nbr,nbc u32 LE][row_ptr u16][col_idx u16][blocks i8].

    Parity with bsr_packer.hpp:492-575.  u16 indices bound geometry to
    65535 block rows/cols — validated here like the reference does.
    """
    if bsr.row_ptr[-1] > 65535:
        raise ValueError("hw stream format: row_ptr exceeds u16 range")
    if bsr.col_idx.size and bsr.col_idx.max() > 65535:
        raise ValueError("hw stream format: col_idx exceeds u16 range")
    header = struct.pack(
        "<III", bsr.nnz_blocks, bsr.num_block_rows, bsr.num_block_cols)
    return (header
            + bsr.row_ptr.astype("<u2").tobytes()
            + bsr.col_idx.astype("<u2").tobytes()
            + np.ascontiguousarray(bsr.data.astype(np.int8)).tobytes())


def deserialize_hw_stream(
    buf: bytes, block_h: int, block_w: int,
    shape: Optional[Tuple[int, int]] = None,
) -> BSRMatrix:
    """Inverse of serialize_hw_stream."""
    nnz, nbr, nbc = struct.unpack_from("<III", buf, 0)
    off = 12
    row_ptr = np.frombuffer(buf, "<u2", nbr + 1, off).astype(np.int32)
    off += (nbr + 1) * 2
    col_idx = np.frombuffer(buf, "<u2", nnz, off).astype(np.int32)
    off += nnz * 2
    data = np.frombuffer(buf, np.int8, nnz * block_h * block_w, off)
    data = data.reshape(nnz, block_h, block_w).copy()
    if shape is None:
        shape = (nbr * block_h, nbc * block_w)
    return BSRMatrix(data=data, row_ptr=row_ptr, col_idx=col_idx,
                     shape=shape, block_h=block_h, block_w=block_w)


# --------------------------------------------------------------------------
# 4. DMA image format (sw/host/memory.py pack_for_dma)
# --------------------------------------------------------------------------

def pack_dma_image(bsr: BSRMatrix, crc: bool = False) -> bytes:
    """[row_ptr u32][col_idx u16][blocks int8] — geometry out of band.

    ``crc=True`` appends a CRC-32 trailer (u32 LE) over the payload —
    the reference's optional DMA integrity check (the CRC-32 transfer
    mode of its AXI host code); unpack verifies it and raises on
    corruption.
    """
    buf = (bsr.row_ptr.astype("<u4").tobytes()
           + bsr.col_idx.astype("<u2").tobytes()
           + np.ascontiguousarray(bsr.data.astype(np.int8)).tobytes())
    if crc:
        buf += struct.pack("<I", zlib.crc32(buf) & 0xFFFFFFFF)
    return buf


def unpack_dma_image(
    buf: bytes, num_block_rows: int, nnz_blocks: int,
    block_h: int, block_w: int,
    shape: Optional[Tuple[int, int]] = None,
    crc: bool = False,
) -> BSRMatrix:
    """Inverse of pack_dma_image given the out-of-band geometry."""
    if crc:
        payload, trailer = buf[:-4], buf[-4:]
        want = struct.unpack("<I", trailer)[0]
        got = zlib.crc32(payload) & 0xFFFFFFFF
        if got != want:
            raise ValueError(
                f"DMA image CRC mismatch: stored {want:#010x}, "
                f"computed {got:#010x}")
        buf = payload
    off = 0
    row_ptr = np.frombuffer(buf, "<u4", num_block_rows + 1, off).astype(np.int32)
    off += (num_block_rows + 1) * 4
    col_idx = np.frombuffer(buf, "<u2", nnz_blocks, off).astype(np.int32)
    off += nnz_blocks * 2
    data = np.frombuffer(buf, np.int8, nnz_blocks * block_h * block_w, off)
    data = data.reshape(nnz_blocks, block_h, block_w).copy()
    if shape is None:
        nbc = int(col_idx.max()) + 1 if col_idx.size else 0
        shape = (num_block_rows * block_h, nbc * block_w)
    return BSRMatrix(data=data, row_ptr=row_ptr, col_idx=col_idx,
                     shape=shape, block_h=block_h, block_w=block_w)
