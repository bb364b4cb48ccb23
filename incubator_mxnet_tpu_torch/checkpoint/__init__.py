"""Checkpointing (the port of ``incubator_mxnet_tpu/checkpoint``): so far
the on-disk step format, ``manifest``, which the serving engine's disk
cache tier writes through. The checkpoint manager and training capsules
are not ported yet.
"""

from . import manifest
from .manifest import gc_steps, list_steps, load_step, step_dir, write_step

__all__ = ["manifest", "write_step", "load_step", "list_steps",
           "gc_steps", "step_dir"]
