"""Multi-device scaling: device meshes over spawned ranks, sharded
training and serving, pipeline, sequence, expert and head parallelism.

Counterpart of ``resnet_accel_tpu/parallel``: the same programs, each run
in every rank of a world that ``launch.run_world`` spawns (one process a
rank, ``torch.distributed`` between them: gloo on the CPU, NCCL on cards,
or gloo with ranks sharing a card), over a ``DeviceMesh`` with the JAX
package's axis names.  The JAX names below are loaded from their modules
at first use.
"""

import importlib

_EXPORTS = {
    "available_devices": "launch",
    "run_world": "launch",
    "make_mesh": "mesh",
    "named_mesh": "mesh",
    "batch_sharding": "mesh",
    "replicated": "mesh",
    "tp_row_sharding": "mesh",
    "make_sharded_train_step": "sharded",
    "make_data_parallel_forward": "sharded",
    "make_pipeline_forward": "pipeline",
    "mnist_pipeline_stages": "pipeline",
    "transformer_pipeline_stages": "pipeline",
    "make_combined_mesh": "combined",
    "make_combined_forward": "combined",
    "make_combined_train_step": "combined",
    "make_sp_transformer_forward": "sequence",
    "make_ep_moe_forward": "experts",
    "make_tp_transformer_forward": "heads",
}

__all__ = ["available_devices", "make_mesh", "batch_sharding", "replicated",
           "tp_row_sharding", "make_sharded_train_step",
           "make_data_parallel_forward", "make_pipeline_forward",
           "mnist_pipeline_stages", "transformer_pipeline_stages",
           "make_combined_mesh", "make_combined_forward",
           "make_combined_train_step", "make_sp_transformer_forward",
           "make_ep_moe_forward", "make_tp_transformer_forward"]


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
