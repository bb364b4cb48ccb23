"""The SSD single-shot detector: the port of the JAX package's
``incubator_mxnet_tpu/models/ssd.py`` (reference: ``example/ssd/`` and
the MultiBox ops of src/operator/contrib/multibox_*.cc).

A compact SSD: three conv stages as the backbone, extra 128-channel
downsampling stages, a global max-pooled last scale, and per-scale class
and box conv heads. Anchors come from ``MultiBoxPrior`` per scale,
training targets from ``MultiBoxTarget`` (with hard negative mining),
detections from ``MultiBoxDetection`` (``ops/contrib.py``). The gluon
structure is the JAX model's, so the structural parameter names match
and ``models.convert.block_params_from_jax`` carries the weights across.
At 300 x 300 the five scales are 37², 19², 10², 5² and 1² cells with 4
anchors each: 7424 anchors."""

from __future__ import annotations

from ..gluon import nn
from ..gluon.block import HybridBlock

__all__ = ["SSD", "ssd_300"]


def _down_block(channels):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(channels // 2, kernel_size=1))
    out.add(nn.BatchNorm())
    out.add(nn.Activation("relu"))
    out.add(nn.Conv2D(channels, kernel_size=3, strides=2, padding=1))
    out.add(nn.BatchNorm())
    out.add(nn.Activation("relu"))
    return out


class SSD(HybridBlock):
    """Multi-scale detector. ``forward(x)`` returns
    (anchors (1, N, 4), cls_preds (B, num_classes+1, N),
    box_preds (B, N*4))."""

    def __init__(self, num_classes=20,
                 sizes=((0.1, 0.14), (0.2, 0.27), (0.37, 0.44),
                        (0.54, 0.62), (0.71, 0.79)),
                 ratios=((1, 2, 0.5),) * 5,
                 base_channels=(32, 64, 128), **kwargs):
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self._sizes = sizes
        self._ratios = ratios
        num_scales = len(sizes)
        with self.name_scope():
            self.backbone = nn.HybridSequential(prefix="backbone_")
            with self.backbone.name_scope():
                for c in base_channels:
                    self.backbone.add(nn.Conv2D(c, 3, padding=1,
                                                use_bias=False))
                    self.backbone.add(nn.BatchNorm())
                    self.backbone.add(nn.Activation("relu"))
                    self.backbone.add(nn.MaxPool2D(2, 2))
            self.stages = nn.HybridSequential(prefix="stages_")
            with self.stages.name_scope():
                for _ in range(num_scales - 2):
                    self.stages.add(_down_block(128))
            self.cls_heads = nn.HybridSequential(prefix="cls_")
            self.box_heads = nn.HybridSequential(prefix="box_")
            with self.cls_heads.name_scope():
                for i in range(num_scales):
                    A = len(sizes[i]) + len(ratios[i]) - 1
                    self.cls_heads.add(nn.Conv2D(
                        A * (num_classes + 1), 3, padding=1))
            with self.box_heads.name_scope():
                for i in range(num_scales):
                    A = len(sizes[i]) + len(ratios[i]) - 1
                    self.box_heads.add(nn.Conv2D(A * 4, 3, padding=1))

    def hybrid_forward(self, F, x):
        feats = [self.backbone(x)]
        for stage in self.stages:
            feats.append(stage(feats[-1]))
        # final global scale
        feats.append(F.Pooling(feats[-1], global_pool=True,
                               pool_type="max", kernel=(1, 1)))
        anchors, cls_preds, box_preds = [], [], []
        for i, feat in enumerate(feats):
            anchors.append(F.MultiBoxPrior(feat, sizes=self._sizes[i],
                                           ratios=self._ratios[i]))
            c = self.cls_heads[i](feat)  # (B, A*(C+1), H, W)
            b = self.box_heads[i](feat)  # (B, A*4, H, W)
            cls_preds.append(F.reshape(F.transpose(c, axes=(0, 2, 3, 1)),
                                       shape=(0, -1, self.num_classes + 1)))
            box_preds.append(F.reshape(F.transpose(b, axes=(0, 2, 3, 1)),
                                       shape=(0, -1)))
        anchors = F.concat(*anchors, dim=1)
        cls_preds = F.transpose(F.concat(*cls_preds, dim=1),
                                axes=(0, 2, 1))  # (B, C+1, N)
        box_preds = F.concat(*box_preds, dim=1)  # (B, N*4)
        return anchors, cls_preds, box_preds

    def training_targets(self, anchors, cls_preds, labels):
        """(box_target, box_mask, cls_target) via MultiBoxTarget."""
        from .. import ndarray as nd
        return nd.MultiBoxTarget(anchors, labels, cls_preds,
                                 negative_mining_ratio=3.0)

    def loss(self, cls_preds, box_preds, box_target, box_mask, cls_target):
        """Joint SSD loss: masked softmax-CE over classes (entries with
        cls_target < 0 are hard-negative-mining IGNORES and contribute
        zero gradient) + smooth-L1 on masked box offsets."""
        from .. import ndarray as nd
        keep = cls_target >= 0
        safe_t = nd.where(keep, cls_target,
                          nd.zeros_like(cls_target))
        logp = nd.log_softmax(cls_preds, axis=1)  # (B, C+1, N)
        picked = nd.pick(logp, safe_t, axis=1)
        ce = -(picked * keep).sum() / nd.maximum(keep.sum(), 1.0)
        diff = nd.abs(box_preds * box_mask - box_target * box_mask)
        sl1 = nd.where(diff > 1.0, diff - 0.5, 0.5 * diff * diff)
        box_l = sl1.sum() / nd.maximum(box_mask.sum(), 1.0)
        return ce + box_l

    def detect(self, cls_preds, box_preds, anchors, nms_threshold=0.45,
               threshold=0.01, nms_topk=400):
        """Decoded detections (B, N, 6) via MultiBoxDetection."""
        from .. import ndarray as nd
        probs = nd.softmax(cls_preds, axis=1)
        return nd.MultiBoxDetection(probs, box_preds, anchors,
                                    nms_threshold=nms_threshold,
                                    threshold=threshold, nms_topk=nms_topk)


def ssd_300(num_classes=20, **kwargs):
    """SSD sized for 300x300 inputs (the reference example's headline
    config)."""
    return SSD(num_classes=num_classes, **kwargs)
