"""Training over devices in the PyTorch port: meshes over a
``torch.distributed`` process group (``mesh``), the collectives
(``collectives``), ``SPMDTrainer`` over a dp x fsdp x tp x sp mesh with
``constrain`` / ``activation_sharding_scope`` (``spmd``), the
pipelined-backward step (``pipelined``), ring attention over the sp axis
(``ring_attention``), GPipe over the pp axis (``pipeline``) and Switch
MoE over the ep axis (``moe``): the counterparts of the JAX package's
``parallel/__init__.py`` names.
"""

from . import collectives, mesh, moe, pipeline, pipelined, ring_attention
from . import spmd
from .collectives import host_allreduce
from .mesh import (MeshConfig, build_mesh, current_mesh, default_mesh,
                   initialize, set_default_mesh)
from .moe import stack_expert_params, switch_moe
from .pipeline import pipeline_apply, stack_stage_params
from .ring_attention import ring_flash_attention, ring_self_attention
from .spmd import (SPMDTrainer, activation_sharding_scope, constrain,
                   gather_full_params, replicate, shard_params)

__all__ = [
    "MeshConfig", "build_mesh", "current_mesh", "default_mesh",
    "set_default_mesh", "initialize", "collectives", "host_allreduce",
    "SPMDTrainer", "shard_params", "replicate", "gather_full_params",
    "constrain", "activation_sharding_scope", "ring_self_attention",
    "ring_flash_attention", "mesh", "spmd", "ring_attention", "pipeline",
    "pipelined", "moe", "pipeline_apply", "stack_stage_params",
    "switch_moe", "stack_expert_params",
]
