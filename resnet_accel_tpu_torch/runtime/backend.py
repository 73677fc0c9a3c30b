"""Device seam: which device runs the port.

Counterpart of ``resnet_accel_tpu/runtime/backend.py``, made explicit: the
caller names the device.  ``cuda`` runs the hand-written kernels and
``cpu`` their plain PyTorch versions.  ``cuda`` with no card raises; there
is no silent fallback to the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

VALID_DEVICES = ("cuda", "cpu")


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``"cuda"``, ``"cuda:N"`` or ``"cpu"`` (or a ``torch.device``) ->
    ``torch.device``; raise if it is unknown or absent."""
    try:
        dev = torch.device(device)
    except RuntimeError:
        dev = None
    if dev is None or dev.type not in VALID_DEVICES:
        raise ValueError(f"unknown device {device!r}; expected one of "
                         f"{VALID_DEVICES}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
