"""Resumable training checkpoints as npz files.

Counterpart of ``resnet_accel_tpu/train/checkpoint.py``: its
``CheckpointManager`` in the layout of that module's npz branch, one
``step_{n}.npz`` of named arrays a step, keeping the newest
``max_to_keep`` as its orbax branch does.  ``save_orbax`` and
``load_orbax`` are not ported: orbax is a JAX library.  The portable
artifact the CLI's ``quantize`` reads is ``train.mnist.save_checkpoint``'s
npz.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch


def _host(v: Any) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class CheckpointManager:
    """Keep the latest-k training checkpoints (resume-after-interrupt)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _steps(self):
        return sorted(int(f[5:-4]) for f in os.listdir(self.directory)
                      if f.startswith("step_") and f.endswith(".npz"))

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.npz")

    def save(self, step: int, tree: Dict[str, Any]) -> None:
        """Write ``tree`` (arrays or tensors by name) as ``step``'s npz,
        then drop the oldest beyond ``max_to_keep``."""
        np.savez(self._path(step), **{k: _host(v) for k, v in tree.items()})
        for old in self._steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None) -> Dict[str, np.ndarray]:
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        with np.load(self._path(step)) as data:
            return {k: data[k] for k in data.files}
