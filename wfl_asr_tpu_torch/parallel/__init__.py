"""Data, fully-sharded, tensor, sequence and pipeline parallelism, the port
of ``wfl_asr_tpu/parallel/``."""

from .fsdp import (MIN_SHARD_SIZE, FullTensorStep, fsdp_spec,
                   full_state_dict, shard_params_fsdp)
from .mesh import (Mesh, make_mesh, maybe_initialize_distributed, node_count,
                   rank, replicate, shard_batch, shard_origin, world_size)
from .pp import (PipelineMesh, gpipe_apply, make_pp_mesh, pp_spec,
                 shard_params_pp)
from .sp import gather_time, shard_time, sp_active
from .tp import shard_params_tp, tp_spec

__all__ = ["MIN_SHARD_SIZE", "FullTensorStep", "fsdp_spec",
           "full_state_dict", "shard_params_fsdp", "Mesh", "make_mesh",
           "maybe_initialize_distributed", "node_count", "rank", "replicate",
           "shard_batch", "shard_origin", "world_size", "gather_time",
           "shard_time", "sp_active", "shard_params_tp", "tp_spec",
           "PipelineMesh", "gpipe_apply", "make_pp_mesh", "pp_spec",
           "shard_params_pp"]
