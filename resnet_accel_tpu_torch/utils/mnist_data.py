"""MNIST IDX file loading (no torchvision download; zero-egress friendly).

Reads the raw idx{1,3}-ubyte files (optionally .gz) that the reference
ships under data/MNIST/raw.  A copy of ``resnet_accel_tpu/utils/
mnist_data.py``, so that the port imports nothing of the JAX package;
``tests/test_torch_train_mnist.py`` holds the two equal.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Tuple

import numpy as np


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def load_idx_images(path: str) -> np.ndarray:
    with _open(path) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"{path}: bad magic {magic} for images")
        data = np.frombuffer(f.read(n * rows * cols), dtype=np.uint8)
    return data.reshape(n, rows, cols)


def load_idx_labels(path: str) -> np.ndarray:
    with _open(path) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"{path}: bad magic {magic} for labels")
        return np.frombuffer(f.read(n), dtype=np.uint8).astype(np.int32)


def load_mnist_split(raw_dir: str, split: str = "t10k"
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Load (images uint8 [N,28,28], labels int32 [N]) from an MNIST raw
    dir, accepting either plain or .gz files."""
    imgs = labels = None
    for suffix in ("", ".gz"):
        ip = os.path.join(raw_dir, f"{split}-images-idx3-ubyte{suffix}")
        lp = os.path.join(raw_dir, f"{split}-labels-idx1-ubyte{suffix}")
        if imgs is None and os.path.isfile(ip):
            imgs = load_idx_images(ip)
        if labels is None and os.path.isfile(lp):
            labels = load_idx_labels(lp)
    if imgs is None or labels is None:
        raise FileNotFoundError(f"MNIST {split} files not found in {raw_dir}")
    return imgs, labels


def save_idx_split(raw_dir: str, images: np.ndarray, labels: np.ndarray,
                   split: str = "t10k") -> None:
    """Write (images uint8 [N,28,28], labels [N]) as the plain IDX files
    ``load_mnist_split`` reads: big-endian headers (magic 2051 and 2049),
    then the bytes."""
    images = np.asarray(images, np.uint8)
    labels = np.asarray(labels).astype(np.uint8)
    os.makedirs(raw_dir, exist_ok=True)
    n, rows, cols = images.shape
    with open(os.path.join(raw_dir, f"{split}-images-idx3-ubyte"), "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, rows, cols))
        f.write(images.tobytes())
    with open(os.path.join(raw_dir, f"{split}-labels-idx1-ubyte"), "wb") as f:
        f.write(struct.pack(">II", 2049, len(labels)))
        f.write(labels.tobytes())


def synthetic_digits(n: int, seed: int = 0
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """A seeded stand-in for an MNIST split where the real files are
    absent: (images uint8 [n,28,28], labels int32 [n]), each image dim
    noise with a bright 7x7 patch at one of ten places, its class."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n).astype(np.int32)
    images = rng.integers(0, 48, (n, 28, 28)).astype(np.uint8)
    for i, c in enumerate(labels):
        r, k = 2 + 12 * (c // 5), 1 + 5 * (c % 5)
        images[i, r:r + 7, k:k + 7] = rng.integers(160, 256, (7, 7))
    return images, labels
