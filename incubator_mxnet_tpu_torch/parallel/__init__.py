"""Training over devices in the PyTorch port: meshes over a
``torch.distributed`` process group (``mesh``), the collectives
(``collectives``), ``SPMDTrainer`` over a dp x fsdp x tp x sp mesh with
``constrain`` / ``activation_sharding_scope`` (``spmd``) and ring
attention over the sp axis (``ring_attention``), the counterparts of the
JAX package's ``parallel/__init__.py`` names.

Pipeline and expert parallelism (``pipeline``, ``pipelined``, ``moe`` and
their functions) are ROADMAP Queue 1 item 11's next slice: reading one of
their names raises ``MXNetError``.
"""

from ..base import MXNetError
from . import collectives, mesh, ring_attention, spmd
from .collectives import host_allreduce
from .mesh import (MeshConfig, build_mesh, current_mesh, default_mesh,
                   initialize, set_default_mesh)
from .ring_attention import ring_flash_attention, ring_self_attention
from .spmd import (SPMDTrainer, activation_sharding_scope, constrain,
                   gather_full_params, replicate, shard_params)

__all__ = [
    "MeshConfig", "build_mesh", "current_mesh", "default_mesh",
    "set_default_mesh", "initialize", "collectives", "host_allreduce",
    "SPMDTrainer", "shard_params", "replicate", "gather_full_params",
    "constrain", "activation_sharding_scope", "ring_self_attention",
    "ring_flash_attention", "mesh", "spmd", "ring_attention",
]

_NEXT_SLICE = ("pipeline", "pipelined", "moe", "pipeline_apply",
               "stack_stage_params", "switch_moe", "stack_expert_params")


def __getattr__(name):
    if name in _NEXT_SLICE:
        raise MXNetError(
            f"parallel.{name} is not ported yet (pipeline and expert "
            f"parallelism: ROADMAP Queue 1 item 11)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
