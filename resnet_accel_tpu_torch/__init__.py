"""resnet_accel_tpu_torch -- the INT8 ResNet-18 inference path of
``resnet_accel_tpu`` in PyTorch, with hand-written CUDA kernels for an
NVIDIA H100 (``sm_90a``).

The JAX package ``resnet_accel_tpu`` is the reference this package is
held against, bit for bit.  This package imports no JAX and nothing of
the JAX package.

- ``ops``      -- the three kernel wrappers (``stem_conv_pool``,
                  ``conv2d_int8``, ``matmul_int8``), each with its plain
                  PyTorch version, and the int8 epilogues and pools.
- ``models``   -- ResNet-18: fp32 init, quantization, the ``.npz`` model
                  container and the forward module.
- ``runtime``  -- the device seam and the inference engine.
- ``quant``    -- per-channel int8 weight quantization (numpy).
- ``_kernels`` -- builds ``csrc/*.cu`` with nvcc at first CUDA use and
                  launches the kernels through ctypes.

Usage: ``python -m resnet_accel_tpu_torch infer --model resnet18
--input x.npy --device cuda``.
"""

__version__ = "0.1.0"
