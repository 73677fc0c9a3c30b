"""Device seam and inference engine."""

from resnet_accel_tpu_torch.runtime.backend import resolve_device

__all__ = ["resolve_device"]
