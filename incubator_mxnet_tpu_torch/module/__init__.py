"""``mx.mod``: MXNet 1.x's symbolic trainers (``Module``,
``BucketingModule``)."""

from .module import BaseModule, Module
from .bucketing_module import BucketingModule

__all__ = ["BaseModule", "Module", "BucketingModule"]
