"""Parallelism layer, PyTorch port of ``deepearth_tpu/parallel``: mesh
construction, sharding rules, ring (sequence-parallel) attention and GPipe
pipeline parallelism over ``torch.distributed`` process groups."""

from .mesh import (
    AXES,
    Mesh,
    Sharding,
    batch_sharding,
    create_mesh,
    make_param_shardings,
    param_spec,
    process_local_batch_indices,
    replicated,
    shard_batch,
    shard_params,
)
from .pipeline import pipeline_apply, stack_stage_params, stage_param_sharding
from .ring import ring_attention

__all__ = [
    "AXES",
    "Mesh",
    "Sharding",
    "batch_sharding",
    "create_mesh",
    "make_param_shardings",
    "param_spec",
    "pipeline_apply",
    "process_local_batch_indices",
    "replicated",
    "ring_attention",
    "shard_batch",
    "shard_params",
    "stack_stage_params",
    "stage_param_sharding",
]
