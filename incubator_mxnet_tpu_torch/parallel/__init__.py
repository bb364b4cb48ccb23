"""Training over devices in the PyTorch port: meshes over a
``torch.distributed`` process group (``mesh``), the collectives
(``collectives``) and ``SPMDTrainer`` over a dp x fsdp mesh (``spmd``),
the counterparts of the JAX package's ``parallel/__init__.py`` names.

Tensor, sequence, pipeline and expert parallelism (``pipeline``,
``moe``, ``ring_attention`` and their functions) are ROADMAP Queue 1
item 11's next slice: reading one of their names raises ``MXNetError``.
"""

from ..base import MXNetError
from . import collectives, mesh, spmd
from .collectives import host_allreduce
from .mesh import (MeshConfig, build_mesh, current_mesh, default_mesh,
                   initialize, set_default_mesh)
from .spmd import SPMDTrainer, gather_full_params, replicate, shard_params

__all__ = [
    "MeshConfig", "build_mesh", "current_mesh", "default_mesh",
    "set_default_mesh", "initialize", "collectives", "host_allreduce",
    "SPMDTrainer", "shard_params", "replicate", "gather_full_params",
    "mesh", "spmd",
]

# constrain / activation_sharding_scope pin activations for the tp axis
_NEXT_SLICE = ("pipeline", "pipelined", "moe", "ring_attention",
               "pipeline_apply", "stack_stage_params", "switch_moe",
               "stack_expert_params", "ring_self_attention",
               "ring_flash_attention", "constrain",
               "activation_sharding_scope")


def __getattr__(name):
    if name in _NEXT_SLICE:
        raise MXNetError(
            f"parallel.{name} is not ported yet (tensor, sequence, "
            f"pipeline and expert parallelism: ROADMAP Queue 1 item 11)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
