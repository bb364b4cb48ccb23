"""Device meshes and the multi-process bootstrap: the port of the JAX
package's ``incubator_mxnet_tpu/parallel/mesh.py`` over
``torch.distributed``.

Every process of a job runs the same program on one device: rank ``r``
drives ``cuda:r`` (one host), or the CPU under gloo. ``initialize()``
forms the process group from the variables ``tools/launch.py`` sets
(``MXTPU_COORDINATOR``, ``MXTPU_NUM_PROCS``, ``MXTPU_PROC_ID``): NCCL
when the current context is a GPU, gloo when it is the CPU. A GPU job
larger than the visible GPUs, or one whose NCCL group cannot form,
raises; nothing falls back to gloo or to the CPU.

``build_mesh`` lays the world's ranks out over the six named axes
(``AXES``, size-1 axes kept) as a ``torch.distributed.device_mesh
.DeviceMesh``. A process that formed no group (one process, no
coordinator) gets a ``LocalMesh`` of one rank, with the same ``shape``,
``mesh_dim_names`` and ``size()``: every collective over it is the
identity.

``axis_index`` and ``axis_group`` give a rank's coordinate and the
process group along one axis (the ``DeviceMesh``'s sub-group).

Axis names (as in the JAX package):
    dp    data parallelism (the batch is split; gradients averaged)
    fsdp  parameter sharding fused with dp (optimizer state on the shard)
    tp    tensor parallelism (attention heads, MLP hidden units, the
          optimizer state of vocab-split embeddings)
    sp    sequence parallelism (ring attention over the sequence's blocks)
    pp    pipeline stages (``parallel.pipeline.pipeline_apply``)
    ep    expert parallelism (``parallel.moe.switch_moe``)
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from ..base import MXNetError

__all__ = ["AXES", "MeshConfig", "LocalMesh", "build_mesh",
           "set_default_mesh", "default_mesh", "current_mesh",
           "initialize", "named_sharding", "axis_sizes", "axis_index",
           "axis_group", "world_size",
           "rank", "is_distributed"]

AXES = ("dp", "fsdp", "tp", "sp", "pp", "ep")

_DEFAULT_MESH = None


@dataclasses.dataclass
class MeshConfig:
    """Sizes per logical axis; unspecified axes get size 1 and axes set to
    -1 absorb the remaining devices (at most one -1)."""

    dp: int = -1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    pp: int = 1
    ep: int = 1

    def resolve(self, n_devices: int) -> Dict[str, int]:
        sizes = {a: getattr(self, a) for a in AXES}
        wild = [a for a, s in sizes.items() if s == -1]
        if len(wild) > 1:
            raise MXNetError(f"at most one mesh axis may be -1, got {wild}")
        fixed = 1
        for a, s in sizes.items():
            if s != -1:
                if s <= 0:
                    raise MXNetError(f"mesh axis {a} must be positive or -1")
                fixed *= s
        if wild:
            if n_devices % fixed != 0:
                raise MXNetError(
                    f"{n_devices} devices not divisible by fixed axes "
                    f"product {fixed}")
            sizes[wild[0]] = n_devices // fixed
        else:
            if fixed != n_devices:
                raise MXNetError(
                    f"mesh axes product {fixed} != device count {n_devices}")
        return sizes


class LocalMesh:
    """The mesh of a process with no process group: one rank on one
    device, every axis of size 1 (``DeviceMesh``'s ``shape``,
    ``mesh_dim_names``, ``size()`` and ``get_coordinate()``)."""

    def __init__(self, device_type: str):
        self.device_type = device_type
        self.mesh_dim_names = AXES
        self.shape = (1,) * len(AXES)

    def size(self, mesh_dim=None) -> int:
        return 1

    def get_coordinate(self):
        return [0] * len(AXES)

    def __repr__(self):
        return f"LocalMesh({self.device_type!r})"


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a mesh ``build_mesh`` made."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` of ``mesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))[axis]


def axis_group(mesh, axis: str):
    """The process group of the ranks that differ from this one on
    ``axis`` only (None on a ``LocalMesh``, whose axes are all 1)."""
    if isinstance(mesh, LocalMesh):
        return None
    return mesh.get_group(axis)


def _device_type() -> str:
    from ..context import current_context
    return "cuda" if current_context().device_type == "gpu" else "cpu"


def build_mesh(config: Optional[MeshConfig] = None,
               devices: Optional[Sequence] = None,
               axis_sizes: Optional[Dict[str, int]] = None):
    """The job's mesh: a ``DeviceMesh`` over every rank of the process
    group with the six ``AXES`` (size-1 axes kept), or a ``LocalMesh``
    when this process formed no group. ``axis_sizes`` is shorthand:
    ``build_mesh(axis_sizes={'dp': 2, 'fsdp': 2})``. ``devices`` (the JAX
    package's device list) may only name one device per rank: the mesh
    spans processes, not the devices of one process."""
    n = world_size()
    if devices is not None and len(list(devices)) not in (1, n):
        raise MXNetError(
            f"build_mesh: {len(list(devices))} devices for a world of {n} "
            f"processes; the port runs one device per process")
    if config is None:
        config = MeshConfig(**(axis_sizes or {}))
    sizes = config.resolve(n)
    dtype = _device_type()
    if not is_distributed():
        return LocalMesh(dtype)
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dtype, tuple(sizes[a] for a in AXES),
                            mesh_dim_names=AXES)


def set_default_mesh(mesh):
    global _DEFAULT_MESH
    _DEFAULT_MESH = mesh


def default_mesh():
    """The process-default mesh (every rank on ``dp``) unless
    overridden."""
    global _DEFAULT_MESH
    if _DEFAULT_MESH is None:
        _DEFAULT_MESH = build_mesh()
    return _DEFAULT_MESH


def current_mesh():
    """The default mesh if one was set or built, else None (the JAX
    package also reads a ``with mesh:`` scope, which torch has not)."""
    return _DEFAULT_MESH


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None):
    """Form the process group (replaces the reference's ``tools/launch.py``
    tracker bootstrap). Reads ``MXTPU_COORDINATOR`` / ``MXTPU_NUM_PROCS`` /
    ``MXTPU_PROC_ID`` when the arguments are omitted. A no-op without a
    coordinator in one process, and when the group already exists. The
    backend is NCCL when the current context is a GPU (rank ``r`` takes
    ``cuda:r``), gloo on the CPU."""
    coordinator_address = coordinator_address or os.environ.get(
        "MXTPU_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("MXTPU_NUM_PROCS", "1"))
    if process_id is None:
        process_id = int(os.environ.get("MXTPU_PROC_ID", "0"))
    if is_distributed():
        return
    if coordinator_address is None:
        if num_processes > 1:
            raise MXNetError(
                f"initialize: {num_processes} processes need a "
                f"coordinator address (MXTPU_COORDINATOR)")
        return
    if backend is None:
        backend = "nccl" if _device_type() == "cuda" else "gloo"
    kwargs = {}
    if backend == "nccl":
        visible = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if num_processes > visible:
            raise MXNetError(
                f"initialize: {num_processes} NCCL ranks but {visible} "
                f"visible GPUs on this host (one GPU a rank; the port "
                f"does not fall back to gloo or the CPU)")
        device = torch.device("cuda", process_id)
        torch.cuda.set_device(device)
        kwargs["device_id"] = device
    addr = coordinator_address if "://" in coordinator_address \
        else "tcp://" + coordinator_address
    try:
        dist.init_process_group(backend, init_method=addr,
                                world_size=num_processes, rank=process_id,
                                **kwargs)
    except (RuntimeError, ValueError) as e:
        raise MXNetError(f"initialize: the {backend} process group of "
                         f"{num_processes} did not form: {e}") from e
    set_default_mesh(None)      # the default is now the group's


def named_sharding(mesh, *spec):
    """The DTensor placements of ``spec`` over ``mesh`` (the counterpart
    of the JAX ``NamedSharding(mesh, PartitionSpec(*spec))``): one
    placement per mesh axis, ``Shard(d)`` where ``spec[d]`` names the
    axis, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    placements = []
    for axis in mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec)
                if e == axis or (isinstance(e, tuple) and axis in e)]
        placements.append(Shard(dims[0]) if dims else Replicate())
    return placements
