"""Faster R-CNN: the port of the JAX package's
``incubator_mxnet_tpu/models/faster_rcnn.py`` (reference: the GluonCV
Faster-RCNN zoo over src/operator/contrib/proposal.cc and roi_align.cc).

Every stage has a fixed shape:
  - backbone: four stride-2 conv stages, a stride-16 feature map;
  - RPN: a 3x3 conv, then objectness and box deltas into the
    ``Proposal`` op (``rpn_post_nms_top_n`` rows, an invalid row zeroed);
  - RoI head: ``ROIAlign``, a shared two-layer MLP, per-class scores and
    class-agnostic box deltas.

The gluon structure is the JAX model's, so the structural parameter names
match (``models.convert.block_params_from_jax``). The forward is
``rpn_forward`` then ``roi_forward``: the proposals are a selection by
score, so a reference on another device can run the RoI half from this
run's RPN probabilities, where scores an ulp apart would otherwise
select different proposals. Gradients reach the RPN's
box branch through the proposals' coordinates, as they do in the JAX
model."""

from __future__ import annotations

from ..gluon import nn
from ..gluon.block import HybridBlock
from .. import initializer as init

__all__ = ["FasterRCNN", "faster_rcnn_small"]


class _Backbone(HybridBlock):
    """4x stride-2 conv stages -> stride-16 feature map."""

    def __init__(self, channels=(32, 64, 128, 256), **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.body = nn.HybridSequential()
            for c in channels:
                self.body.add(nn.Conv2D(c, 3, strides=2, padding=1,
                                        activation="relu"))

    def hybrid_forward(self, F, x):
        return self.body(x)


class FasterRCNN(HybridBlock):
    """forward(x (B,3,H,W), im_info (B,3)) ->
        (rois (B, R, 5), cls_scores (B, R, num_classes+1),
         box_deltas (B, R, 4), rpn_cls (B, 2A, h, w),
         rpn_box (B, 4A, h, w))"""

    def __init__(self, num_classes=20, feat_channels=256,
                 scales=(2, 4, 8), ratios=(0.5, 1.0, 2.0),
                 rpn_post_nms_top_n=64, roi_size=(7, 7),
                 feature_stride=16, **kwargs):
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self._scales = tuple(scales)
        self._ratios = tuple(ratios)
        self._post_n = int(rpn_post_nms_top_n)
        self._roi_size = tuple(roi_size)
        self._stride = int(feature_stride)
        A = len(scales) * len(ratios)
        with self.name_scope():
            self.backbone = _Backbone()
            self.rpn_conv = nn.Conv2D(feat_channels, 3, padding=1,
                                      activation="relu")
            self.rpn_cls = nn.Conv2D(2 * A, 1)
            self.rpn_box = nn.Conv2D(4 * A, 1)
            self.head_fc1 = nn.Dense(256, flatten=False,
                                     weight_initializer=init.Xavier())
            self.head_fc2 = nn.Dense(256, flatten=False,
                                     weight_initializer=init.Xavier())
            self.cls_score = nn.Dense(num_classes + 1, flatten=False)
            self.box_pred = nn.Dense(4, flatten=False)

    def rpn_forward(self, F, x):
        """(feat (B, C, h, w), rpn_cls (B, 2A, h, w), rpn_box (B, 4A, h, w),
        probs): ``probs`` is the softmax over (bg, fg) of each anchor, in
        rpn_cls's layout."""
        feat = self.backbone(x)
        rpn = self.rpn_conv(feat)
        rpn_cls = self.rpn_cls(rpn)
        rpn_box = self.rpn_box(rpn)
        B, A2, h, w = rpn_cls.shape
        A = A2 // 2
        probs = rpn_cls.reshape((B, 2, A, h, w)) \
            .softmax(axis=1).reshape((B, 2 * A, h, w))
        return feat, rpn_cls, rpn_box, probs

    def roi_forward(self, F, feat, probs, rpn_box, im_info):
        """(rois (B, R, 5), scores (B, R, num_classes+1), deltas (B, R, 4))
        from the RPN's outputs: ``Proposal``, ``ROIAlign`` and the head."""
        B = feat.shape[0]
        rois = F.Proposal(probs, rpn_box, im_info,
                          scales=self._scales, ratios=self._ratios,
                          rpn_pre_nms_top_n=4 * self._post_n,
                          rpn_post_nms_top_n=self._post_n,
                          feature_stride=self._stride)  # (B, R, 5)
        R = rois.shape[1]
        flat_rois = rois.reshape((B * R, 5))
        pooled = F.ROIAlign(feat, flat_rois,
                            pooled_size=self._roi_size,
                            spatial_scale=1.0 / self._stride,
                            sample_ratio=2)           # (B*R, C, ph, pw)
        hfeat = pooled.reshape((B * R, -1))
        hfeat = self.head_fc1(hfeat).relu()
        hfeat = self.head_fc2(hfeat).relu()
        scores = self.cls_score(hfeat).reshape((B, R,
                                                self.num_classes + 1))
        deltas = self.box_pred(hfeat).reshape((B, R, 4))
        return rois, scores, deltas

    def hybrid_forward(self, F, x, im_info):
        feat, rpn_cls, rpn_box, probs = self.rpn_forward(F, x)
        rois, scores, deltas = self.roi_forward(F, feat, probs, rpn_box,
                                                im_info)
        return rois, scores, deltas, rpn_cls, rpn_box


def faster_rcnn_small(num_classes=20, **kwargs) -> FasterRCNN:
    return FasterRCNN(num_classes=num_classes, **kwargs)
