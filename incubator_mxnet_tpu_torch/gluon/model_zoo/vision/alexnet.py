"""AlexNet: the port of the JAX package's
``incubator_mxnet_tpu/gluon/model_zoo/vision/alexnet.py``."""

from __future__ import annotations

from ....base import MXNetError
from ... import nn
from ...block import HybridBlock

__all__ = ["AlexNet", "alexnet"]


class AlexNet(HybridBlock):
    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.Conv2D(64, kernel_size=11, strides=4,
                                        padding=2, activation="relu"))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
            self.features.add(nn.Conv2D(192, kernel_size=5, padding=2,
                                        activation="relu"))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
            self.features.add(nn.Conv2D(384, kernel_size=3, padding=1,
                                        activation="relu"))
            self.features.add(nn.Conv2D(256, kernel_size=3, padding=1,
                                        activation="relu"))
            self.features.add(nn.Conv2D(256, kernel_size=3, padding=1,
                                        activation="relu"))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
            self.features.add(nn.Flatten())
            self.features.add(nn.Dense(4096, activation="relu"))
            self.features.add(nn.Dropout(0.5))
            self.features.add(nn.Dense(4096, activation="relu"))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        x = self.features(x)
        return self.output(x)


def alexnet(pretrained=False, **kwargs):
    if pretrained:
        raise MXNetError("pretrained weights are not bundled; "
                         "load_parameters() a checkpoint instead")
    return AlexNet(**kwargs)
