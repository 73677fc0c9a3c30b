"""resnet_accel_tpu_torch -- the INT8 serving paths of ``resnet_accel_tpu``
(ResNet-18, dense and block-sparse, and the MNIST CNN) in PyTorch, with
hand-written CUDA kernels for an NVIDIA H100 (``sm_90a``).

The JAX package ``resnet_accel_tpu`` is the reference this package is
held against, bit for bit.  This package imports no JAX and nothing of
the JAX package.

- ``ops``      -- the four kernel wrappers (``stem_conv_pool``,
                  ``conv2d_int8``, ``matmul_int8``, ``bsr_matmul_wt``),
                  each with its plain PyTorch version, and the int8
                  epilogues and pools.
- ``sparse``   -- ``BSRMatrix`` and ``build_bsr`` (numpy).
- ``models``   -- ResNet-18: fp32 init, quantization, block pruning and
                  ``attach_bsr``, the ``.npz`` model container and the
                  forward module; the MNIST CNN.
- ``runtime``  -- the device seam, the inference engine (with its typed
                  errors), the performance metrics and chained timing,
                  the per-layer roofline and measured profiles, and power.
- ``native``   -- ctypes binding of the repo's native host library
                  (``native/``, built by g++ at first use): goldens, the
                  BSR packer and the threaded int8 ``BatchLoader``.
- ``train``    -- training through torch.autograd: the MNIST CNN, the
                  ResNet family and the decoder LM, block pruning, QAT and
                  npz checkpoints.
- ``utils``    -- the MNIST IDX reader and a seeded synthetic split.
- ``quant``    -- per-channel int8 weight quantization (numpy).
- ``_kernels`` -- builds ``csrc/*.cu`` with nvcc at first CUDA use and
                  launches the kernels through ctypes.

Usage: ``python -m resnet_accel_tpu_torch infer --model resnet18
--input x.npy --device cuda``; ``... bench --device cuda``.
"""

__version__ = "0.1.0"
