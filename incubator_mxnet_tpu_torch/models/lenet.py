"""LeNet-5, MXNet's ``example/gluon/mnist`` network: the port of the JAX
package's ``incubator_mxnet_tpu/models/lenet.py``."""

from __future__ import annotations

from ..gluon import nn
from ..gluon.block import HybridBlock

__all__ = ["LeNet"]


class LeNet(HybridBlock):
    """Classic LeNet: 2×(conv+pool) → 2×dense → logits."""

    def __init__(self, classes=10, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.conv1 = nn.Conv2D(20, kernel_size=5, activation="relu")
            self.pool1 = nn.MaxPool2D(pool_size=2, strides=2)
            self.conv2 = nn.Conv2D(50, kernel_size=5, activation="relu")
            self.pool2 = nn.MaxPool2D(pool_size=2, strides=2)
            self.fc1 = nn.Dense(500, activation="relu")
            self.fc2 = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        x = self.pool1(self.conv1(x))
        x = self.pool2(self.conv2(x))
        x = self.fc1(x)
        return self.fc2(x)
