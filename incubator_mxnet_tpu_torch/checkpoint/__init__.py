"""Checkpointing: the port of ``incubator_mxnet_tpu/checkpoint``. Async
snapshots with atomic commit (``CheckpointManager``), preemption-safe
final saves, bit-exact training resume through the capsule, and the
serving engine's warm start. The files are the JAX package's: a step
directory or a capsule blob either package writes, the other loads.

Quick use::

    from incubator_mxnet_tpu_torch import checkpoint as ckpt

    mgr = ckpt.CheckpointManager("/ckpts/run0", keep=3)
    trainer.install_preemption(mgr)          # SIGTERM-safe
    for step in range(n):
        ...train...
        if step % 100 == 0:
            trainer.save_checkpoint(mgr)

    # preempted? new process:
    step = trainer.restore_checkpoint(mgr)   # bit-exact
"""

from . import manifest
from .manager import CheckpointManager, gather_tree
from .manifest import (FORMAT_VERSION, MANIFEST_NAME, HostArrays, gc_steps,
                       list_steps, load_step, step_dir, write_step)
from .capsule import (CAPSULE_MAGIC, dump_capsule_bytes, fill_state,
                      flatten_state, is_capsule_bytes,
                      load_capsule_bytes, load_capsule_file,
                      restore_spmd, restore_trainer, restore_updater,
                      save_capsule_file, spmd_capsule, trainer_capsule,
                      updater_capsule)

__all__ = [
    "CheckpointManager", "gather_tree", "manifest", "HostArrays",
    "write_step", "load_step", "list_steps", "gc_steps", "step_dir",
    "FORMAT_VERSION", "MANIFEST_NAME",
    "CAPSULE_MAGIC", "dump_capsule_bytes", "load_capsule_bytes",
    "is_capsule_bytes", "save_capsule_file", "load_capsule_file",
    "trainer_capsule", "restore_trainer", "spmd_capsule", "restore_spmd",
    "updater_capsule", "restore_updater", "flatten_state", "fill_state",
]
