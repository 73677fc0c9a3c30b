"""Training through torch.autograd: dense trainers, progressive block-sparse
pruning, quantization-aware training and npz checkpoints.

Counterpart of ``resnet_accel_tpu/train``, with its exports but
``save_orbax`` and ``load_orbax`` (orbax is a JAX library).  Each trainer
takes ``device`` (``"cuda"`` by default; it raises without a card) and
takes and returns flat dicts of numpy arrays under the JAX package's
names; data order and initial values come from the same
``numpy.random.default_rng(seed)`` calls.  Its models are served through
the kernels: ``export_inference_params`` -> ``quantize_resnet18``,
``export_qat`` -> ``MNISTCNNInt8``, ``train.lm.quantize_lm`` ->
``TransformerLMInt8``.
"""

from resnet_accel_tpu_torch.train.mnist import (
    init_mnist_params,
    mnist_forward_fp32,
    train_mnist,
    save_checkpoint,
    load_checkpoint,
    export_golden_vectors,
    TrainResult,
)
from resnet_accel_tpu_torch.train.checkpoint import CheckpointManager
from resnet_accel_tpu_torch.train.resnet18 import (
    train_resnet18,
    export_inference_params,
    resnet18_forward,
)
from resnet_accel_tpu_torch.train.qat import (
    fake_quant,
    fake_quant_per_channel,
    qat_finetune,
    export_qat,
)
from resnet_accel_tpu_torch.train.blocksparse import (
    BlockCfg,
    DEFAULT_FC_CFG,
    DEFAULT_CONV_CFG,
    REF_FC_CFG,
    REF_CONV_CFG,
    compute_block_norms,
    prune_blocks_global,
    expand_mask,
    make_mask_fn,
    make_group_lasso_fn,
    sparsity_of_masks,
    effective_sparsity,
    progressive_prune,
)

__all__ = [
    "CheckpointManager",
    "train_resnet18",
    "export_inference_params",
    "resnet18_forward",
    "fake_quant",
    "fake_quant_per_channel",
    "qat_finetune",
    "export_qat",
    "init_mnist_params",
    "mnist_forward_fp32",
    "train_mnist",
    "save_checkpoint",
    "load_checkpoint",
    "export_golden_vectors",
    "TrainResult",
    "BlockCfg",
    "DEFAULT_FC_CFG",
    "DEFAULT_CONV_CFG",
    "REF_FC_CFG",
    "REF_CONV_CFG",
    "compute_block_norms",
    "prune_blocks_global",
    "expand_mask",
    "make_mask_fn",
    "make_group_lasso_fn",
    "sparsity_of_masks",
    "effective_sparsity",
    "progressive_prune",
]
