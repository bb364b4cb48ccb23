"""ResNet under ``mx.models.resnet``: the port of the JAX package's
``incubator_mxnet_tpu/models/resnet.py``, a re-export of the gluon model
zoo's ``gluon/model_zoo/vision/resnet.py``."""

from ..gluon.model_zoo.vision.resnet import (  # noqa: F401
    BasicBlockV1, BasicBlockV2, BottleneckV1, BottleneckV2, ResNetV1,
    ResNetV2, get_resnet, resnet18_v1, resnet34_v1, resnet50_v1,
    resnet101_v1, resnet152_v1, resnet18_v2, resnet34_v2, resnet50_v2,
    resnet101_v2, resnet152_v2)

__all__ = ["ResNetV1", "ResNetV2", "get_resnet", "resnet18_v1",
           "resnet34_v1", "resnet50_v1", "resnet101_v1", "resnet152_v1",
           "resnet18_v2", "resnet34_v2", "resnet50_v2", "resnet101_v2",
           "resnet152_v2"]
