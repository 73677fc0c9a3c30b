"""Float checkpoints as the JAX package writes them: one ``.npz`` of named
arrays (``conv1.weight``, ``fc1.bias``, ...), the input of the CLI's
``quantize``.  Counterpart of ``load_checkpoint`` in
``resnet_accel_tpu/train/mnist.py``; ``train.mnist.save_checkpoint``
writes them."""

from __future__ import annotations

from typing import Dict

import numpy as np


def load_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """The arrays of the npz at ``path`` (``.npz`` appended if missing)."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        return {k: data[k] for k in data.files}
